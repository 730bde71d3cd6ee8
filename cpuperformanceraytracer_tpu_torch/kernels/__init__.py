"""Hand-written CUDA kernels of the frame path and their plain versions:
``megakernel`` (kernel A) and ``env_accumulate`` (kernel B); ``_build``
compiles ``csrc/*.cu`` and loads the library."""
