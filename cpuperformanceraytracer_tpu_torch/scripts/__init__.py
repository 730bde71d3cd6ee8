"""The drivers of the JAX package's ``scripts/`` that run BASELINE
configs: ``run_offline_4k`` (config 5, a 4K progressive render with a
checkpoint and a resume) and ``inverse_env_demo`` (config 4 at scale,
albedos and every env texel recovered from one target)."""
