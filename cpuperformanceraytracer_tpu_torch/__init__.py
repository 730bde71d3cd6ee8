"""PyTorch + CUDA port of the path tracer, for one NVIDIA Hopper GPU.

The JAX package ``cpuperformanceraytracer_tpu`` is the reference; this
package keeps its module names where a reader looks for a counterpart
and is tested against it on the same inputs. It imports torch and numpy
and never jax.

Layer map (the slice ported so far: the forward progressive frame):

    app/       CLI (``render``)
    config     RenderConfig + validation
    render/    frame step (kernel A -> kernel B), OfflineRenderer
    kernels/   hand-written CUDA kernels + their plain-torch versions:
               megakernel (A: camera ray + bounce loop -> 12 planes),
               env_accumulate (B: deferred env resolve + accumulate),
               _build (nvcc + ctypes loader)
    csrc/      the CUDA C++ sources of the kernels
    scene/     quads/spheres/materials, builder, presets, camera
    texture/   env texture, equirect lookup, RGBE codec, procedural sky
    core/      Vec3 math, hash RNGs, samplers, color transforms
    io/        BMP/PNG writers, numpy conversion from the JAX package
    utils/     frame timer
"""

__version__ = "0.1.0"
