"""The probes: the JAX package's three probe scripts, ported with their
kernels (K6-K8, the last Pallas kernels of the repo) written by hand for
Hopper. Each asks its script's design question of the H100 and prints
the script's lines:

    trace_probe    scripts/mxu_trace_probe.py: the trace's dot products on
                   CUDA cores or on tensor cores (K6, csrc/probes/trace_dots.cu)
    gather_bench   scripts/gather_bench.py: a race of texel gathers (K7,
                   csrc/probes/texel_gather.cu, beside kernel E and torch)
    overlap_probe  scripts/overlap_probe.py: kernel A and the texel gather
                   on two streams (P1), async row copies with 1 to 8 in
                   flight (P2, K8a, csrc/probes/row_copy.cu), a gather from a table in a
                   cluster's shared memory (P3, K8b, csrc/probes/dsmem_gather.cu)

    python -m cpuperformanceraytracer_tpu_torch.probes.<name> [--backend torch]

The probe kernels build into their own library (``kernels._build.PROBES``)
at first use. Each wrapper takes its plain version for a CPU tensor and
launches its kernel for a CUDA tensor (counted in ``<wrapper>.launches``).
No probe is on a render or training path.
"""
