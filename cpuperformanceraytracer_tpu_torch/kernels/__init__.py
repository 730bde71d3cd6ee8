"""Hand-written CUDA kernels and their plain versions: ``megakernel``
(kernel A, the forward), ``env_accumulate`` (kernel B, the env resolve),
``backward`` (kernel C, the path-replay adjoint, and the differentiable
sample), ``env_backward`` (kernel D, the env cotangents and texel
scatter); ``_build`` compiles ``csrc/*.cu`` and loads the library."""
