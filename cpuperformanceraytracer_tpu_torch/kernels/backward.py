"""Kernel C: the path-replay adjoint of kernel A, its plain version, and
the differentiable sample built on kernels A to D.

Replaces ``cpuperformanceraytracer_tpu/kernels/backward.py``:
``_make_bwd_call`` (the Pallas adjoint kernel) and ``_bwd_tables`` become
``bwd_tables``, launching ``csrc/backward.cu``; ``_diff_sample_fn`` (a
``jax.custom_vjp``) becomes ``DiffSample`` (a ``torch.autograd.Function``);
``render_frame_pallas_diff`` becomes ``render_frame_diff``.

``bwd_tables(tables, cfg, frame, sample0, cot6)`` returns the cotangent of
every cell of the four scene tables (``d_quad, d_sph, d_mat, d_cam``)
given the cotangents ``cot6`` (6, H, W) of kernel A's r, g, b and
miss-throughput planes, for one counter-RNG sample: the JAX
``_bwd_tables`` contract with ``trained=None``. Its plain version,
``bwd_tables_reference``, is ``torch.autograd.grad`` of the plain kernel
A, whose estimator weights are detached (the policy of ``diff/grad.py``).

``DiffSample`` runs kernel A then kernel B (a fresh zero accumulator,
blend 1 and ``index_out``, which gives the colour exactly and the texel
index) forward, and kernel D then kernel C backward. ``render_frame_diff``
packs the tables with the differentiable ``pack_scene``/``pack_camera``,
so autograd carries the table cotangents on to quad vertices, sphere
centers, materials and the camera; spp > 1 runs one dispatch per sample.
The frame is an int or a ``DeviceFrame``: a CUDA graph of K training
steps (``diff/graph.py``) bakes each step's offset in,
and kernels A and C add the frame the host wrote on the device.
``row0``/``local_height`` pick a window of pixel rows, as kernel A's: C
replays the window's pixels from their global rows, and B and D take
the window's buffers as they are (the JAX adjoint's row window,
``backward.py:350-353``; ``parallel/shard.py`` passes it).

Not ported: ``derive_trained``, ``bake_base_tables``, ``_BakedTables``,
``_concretize``, ``_inflate``, ``_bwd_tiles``, ``_fit_bwd_height`` and
``_bwd_stack_bytes``. They are TPU compile-time specialisation and VMEM
fitting: kernel C computes the cotangent of every table cell, and
autograd keeps only what reaches a leaf that requires grad. What JAX's
baking saves per step, the port saves by deriving the quad table of an
untrained scene once where the loss is built (``quad_tbl``, from
``diff/grad.fixed_quad_table``) and by replaying K steps as one CUDA
graph.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cpuperformanceraytracer_tpu_torch.config import resolve_device
from cpuperformanceraytracer_tpu_torch.kernels._build import check, load_library
from cpuperformanceraytracer_tpu_torch.kernels.env_accumulate import env_accumulate
from cpuperformanceraytracer_tpu_torch.kernels.env_backward import env_backward
from cpuperformanceraytracer_tpu_torch.kernels.megakernel import (
    _ROULETTE,
    _aspect,
    _check_tables,
    frame_args,
    pack_camera,
    pack_scene,
    render_planes,
    render_planes_reference,
    window,
)
from cpuperformanceraytracer_tpu_torch.texture.texture import Texture
from cpuperformanceraytracer_tpu_torch.utils import profiling

OUT_PLANES = (0, 1, 2, 6, 7, 8)  # kernel A's r, g, b, mt_x, mt_y, mt_z


def _require_counter(cfg) -> None:
    if cfg.rng != "counter":
        raise ValueError("the adjoint requires rng='counter' (addressable "
                         "per-sample streams for the replay)")


def require_diff_env(cfg) -> None:
    """The env lookups the diff path differentiates: one tap of an
    equirect map or a cubemap (kernels B and D), as the JAX Pallas
    backward."""
    if cfg.env_mode != "none" and cfg.env_sampling == "bilinear":
        raise NotImplementedError(
            "the diff path: env_sampling 'bilinear' is 4-tap (use "
            "stochastic, the reference default, or nearest)")


def bwd_tables_reference(tables, cfg, frame, sample0: int, cot6,
                         row0: int = 0, local_height=None):
    """Plain kernel C: autograd of the plain kernel A's output planes
    (of the row window, as ``bwd_tables``)."""
    _require_counter(cfg)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in tables]
        planes = render_planes_reference(leaves, cfg, frame, sample0,
                                         row0=row0, local_height=local_height)
        grads = torch.autograd.grad(planes[list(OUT_PLANES)], leaves, cot6,
                                    allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g
                 for t, g in zip(tables, grads))


@functools.lru_cache(maxsize=None)
def _grid_blocks(device_index: int, nq: int, ns: int, nm: int, bounces: int,
                 width: int, height: int) -> int:
    """Kernel C's persistent grid on this card (0: the scene's tables, the
    warps' rows and the stacks do not fit in a block's shared memory)."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = load_library().cprt_bwd_tables_blocks(
            nq, ns, nm, bounces, width, height, ctypes.byref(blocks))
    check(err, "bwd_tables")
    return blocks.value


def bwd_tables(tables, cfg, frame, sample0: int, cot6, lane_stats=None,
               row0: int = 0, local_height=None):
    """Kernel C wrapper: ``(d_quad, d_sph, d_mat, d_cam)``; ``frame`` is an
    int or a ``DeviceFrame``. ``cot6`` is (6, local_height, W): the
    cotangents of global rows [row0, row0 + local_height) of the image
    (all of it by default), which the launch replays.

    On the card, ``lane_stats`` (two zeroed int64) receives the lanes that
    ran a step and the lane slots of all warp-iterations."""
    quad_tbl, sph_tbl, mat_tbl, cam_tbl = tables
    _require_counter(cfg)
    if quad_tbl.device.type == "cpu":
        return bwd_tables_reference(tables, cfg, frame, sample0, cot6,
                                    row0, local_height)
    if quad_tbl.device.type != "cuda":
        raise ValueError(f"bwd_tables: unsupported device {quad_tbl.device}")
    if cfg.spp != 1:
        raise ValueError("bwd_tables: one sample per dispatch (spp=1)")
    _check_tables(tables)
    row0, h = window(cfg, row0, local_height)
    w = cfg.width
    if (cot6.shape != (6, h, w) or cot6.dtype != torch.float32
            or not cot6.is_contiguous() or cot6.device != quad_tbl.device):
        raise ValueError(f"bwd_tables: cot6 must be contiguous f32 (6, {h}, "
                         f"{w}) on {quad_tbl.device}, got {tuple(cot6.shape)} "
                         f"{cot6.dtype} {cot6.device}")
    if lane_stats is not None and (lane_stats.shape != (2,)
                                   or lane_stats.dtype != torch.int64
                                   or lane_stats.device != quad_tbl.device):
        raise ValueError(f"bwd_tables: lane_stats must be (2,) int64 on "
                         f"{quad_tbl.device}")
    sizes = [t.numel() for t in tables]
    blocks = _grid_blocks(quad_tbl.device.index or 0, quad_tbl.shape[0],
                          sph_tbl.shape[0], mat_tbl.shape[0], cfg.bounces,
                          w, h)
    if blocks == 0:
        raise ValueError(
            f"bwd_tables: the scene's tables, the warps' rows and the "
            f"stacks of {cfg.bounces} bounces do not fit in a block's "
            "shared memory")
    partials = torch.empty((blocks, sum(sizes)), dtype=torch.float32,
                           device=quad_tbl.device)
    env_draws = cfg.env_mode != "none" and cfg.env_sampling == "stochastic"
    offset, base = frame_args(frame, quad_tbl.device)
    stream = torch.cuda.current_stream(quad_tbl.device).cuda_stream
    err = load_library().cprt_bwd_tables(
        quad_tbl.data_ptr(), quad_tbl.shape[0], sph_tbl.data_ptr(),
        sph_tbl.shape[0], mat_tbl.data_ptr(), mat_tbl.shape[0],
        cam_tbl.data_ptr(), cot6.data_ptr(), partials.data_ptr(), blocks, w,
        cfg.height, row0, h, offset, int(sample0), cfg.bounces, int(env_draws),
        int(cfg.env_mode == "none"), _ROULETTE[cfg.roulette],
        int(cfg.unit_vector_sampler == "zangle"), int(cfg.jitter),
        ctypes.c_float(_aspect(cfg)),
        None if lane_stats is None else lane_stats.data_ptr(), base, stream)
    check(err, "bwd_tables")
    profiling.count_launch(bwd_tables)
    flat = torch.sum(partials, dim=0)  # a fixed shape: a fixed order
    return tuple(part.reshape(t.shape)
                 for part, t in zip(torch.split(flat, sizes), tables))


bwd_tables.launches = 0


class DiffSample(torch.autograd.Function):
    """One differentiable sample: (quad, sph, mat, cam, tex_r, tex_g,
    tex_b) -> colour (3, local_height, W) of the row window ``rows`` =
    (row0, local_height), the whole image when None. ``cfg`` has spp=1;
    ``frame`` is an int or a
    ``DeviceFrame`` (kept in ``ctx``, so kernel C reads the frame kernel A
    read), ``sample0`` an int; ``tex_shape`` is the texture's (width,
    height). Kernels B and D take the window's buffers as they are (per
    pixel and per run record), so only A and C see the window. With
    tracing on, A and C count their lanes into ``utils/profiling``'s
    ``kernel_a`` and ``kernel_c`` counters."""

    @staticmethod
    def forward(ctx, cfg, frame, sample0, tex_shape, quad, sph, mat, cam,
                tex_r, tex_g, tex_b, rows=None):
        tables = (quad, sph, mat, cam)
        row0, h = rows = window(cfg, *(rows or (0, None)))
        planes = render_planes(
            tables, cfg, frame, sample0, row0=row0, local_height=h,
            lane_stats=profiling.lane_counter("kernel_a", quad.device))
        env = cfg.env_mode != "none"
        texture = Texture(tex_r, tex_g, tex_b, *tex_shape) if env else None
        color = torch.zeros((3, h, cfg.width), dtype=torch.float32,
                            device=quad.device)
        idx = (torch.empty((h, cfg.width), dtype=torch.int64,
                           device=quad.device) if env else None)
        env_accumulate(planes, texture, cfg.replace(height=h), color, 1.0,
                       index_out=idx)
        ctx.save_for_backward(quad, sph, mat, cam, tex_r, tex_g, tex_b)
        ctx.cfg, ctx.frame, ctx.sample0, ctx.tex_shape = cfg, frame, sample0, tex_shape
        ctx.rows, ctx.idx, ctx.mt = rows, idx, planes[6:9]
        return color

    @staticmethod
    def backward(ctx, g):
        quad, sph, mat, cam, tex_r, tex_g, tex_b = ctx.saved_tensors
        cfg = ctx.cfg
        g = g.contiguous()
        if cfg.env_mode != "none":
            texture = Texture(tex_r, tex_g, tex_b, *ctx.tex_shape)
            cot_mt, d_tex = env_backward(g, ctx.idx, ctx.mt, texture)
        else:
            cot_mt, d_tex = torch.zeros_like(g), (None, None, None)
        cot6 = torch.cat([g, cot_mt])
        d_tables = bwd_tables(
            (quad, sph, mat, cam), cfg, ctx.frame, ctx.sample0, cot6,
            lane_stats=profiling.lane_counter("kernel_c", quad.device),
            row0=ctx.rows[0], local_height=ctx.rows[1])
        return (None, None, None, None, *d_tables, *d_tex, None)


def render_frame_diff(scene, camera, texture, cfg, frame,
                      spp_offset: int = 0, quad_tbl=None, row0: int = 0,
                      local_height=None) -> torch.Tensor:
    """Differentiable frame on the CUDA kernels: (3, local_height, W)
    colour of global rows [row0, row0 + local_height) (the whole image by
    default), the mean of ``cfg.spp`` samples starting at sample
    ``spp_offset``; ``frame`` is an int or a ``DeviceFrame``; ``quad_tbl``
    is the scene's quad table when the caller derived it. The window and
    the sample offset are the sharding hooks of the JAX
    ``render_frame_pallas_diff`` (``parallel/shard.py`` passes them)."""
    rows = window(cfg, row0, local_height)
    cfg = cfg.validate()
    if cfg.backend != "cuda":
        raise ValueError("render_frame_diff runs the CUDA kernels (backend "
                         f"'cuda'), got backend {cfg.backend!r}")
    _require_counter(cfg)
    require_diff_env(cfg)
    device = resolve_device("cuda")
    quad, sph, mat = (t.to(device).contiguous()
                      for t in pack_scene(scene, quad_tbl))
    cam = pack_camera(camera, cfg).to(device).contiguous()
    if texture is not None and cfg.env_mode != "none":
        tex = tuple(t.to(device).contiguous() for t in texture[:3])
        tex_shape = (texture.width, texture.height)
    else:
        tex = (torch.zeros(1, device=device),) * 3
        tex_shape = (0, 0)
    one = cfg.replace(spp=1)
    acc = None
    for s in range(cfg.spp):
        color = DiffSample.apply(one, frame, int(spp_offset) + s,
                                 tex_shape, quad, sph, mat, cam, *tex, rows)
        acc = color if acc is None else acc + color
    return acc if cfg.spp == 1 else acc * (1.0 / cfg.spp)
