"""PyTorch + CUDA port of the path tracer, for one NVIDIA Hopper GPU.

The JAX package ``cpuperformanceraytracer_tpu`` is the reference; this
package keeps its module names where a reader looks for a counterpart
and is tested against it on the same inputs. It imports torch and numpy
and never jax.

Layer map (the slices ported so far: the forward progressive frame, the
fwd+bwd training step, and the textured multi-sample frame with the
display path):

    app/       CLI (``render``, ``watch``, ``bench``, ``bench-grad``,
               ``inverse``)
    config     RenderConfig + validation, resolve_device, BENCH_CONFIGS
    render/    frame step (kernel A -> kernel B; A -> E -> F for an env
               map with spp > 1, bilinear or cubemap), display (kernel G),
               OfflineRenderer (progress, checkpoint/resume)
    diff/      apply_params + L2 loss and gradients, the timed fwd+bwd
               step, Adam inverse rendering
    kernels/   hand-written CUDA kernels + their plain-torch versions:
               megakernel (A: camera ray + bounce loop -> 12 planes),
               env_accumulate (B: deferred env resolve + accumulate),
               backward (C: path-replay adjoint -> table cotangents;
               DiffSample, render_frame_diff), env_backward (D: env
               cotangents + texel scatter), env_gather (E: env lookup of
               every mode, texel fetch), combine (F: multi-sample combine
               + accumulate), tonemap (G: exposure, ACES, sRGB), _build
               (nvcc + ctypes)
    csrc/      the CUDA C++ sources; bounce.cuh is the bounce body
               kernels A and C share
    scene/     quads/spheres/materials, builder, presets, camera
    texture/   env texture, equirect and cubemap lookups, RGBE codec,
               procedural sky
    core/      Vec3 math, hash RNGs, samplers, color transforms
    io/        BMP/PNG writers, checkpoint/resume (the JAX package's
               format), numpy conversion from the JAX package
    utils/     timers, logging and progress, terminal live view
"""

from cpuperformanceraytracer_tpu_torch.config import (  # noqa: F401
    BENCH_CONFIGS,
    RenderConfig,
)

__version__ = "0.1.0"
