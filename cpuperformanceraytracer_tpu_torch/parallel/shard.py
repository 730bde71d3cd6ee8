"""Pixel-row and sample sharding of the frame and of the training step.

Counterpart of ``cpuperformanceraytracer_tpu.parallel.shard``: the JAX
package's shard_map over a (px, spp) mesh becomes one process per mesh
cell (``parallel/mesh.py``). Pixel rows shard over "px": rank (p, s)
renders global rows [p * H/n_px, (p + 1) * H/n_px) through kernel A's
row window (each pixel keyed and cast from its global row, so a window
is bit-equal to those rows of the whole frame). Samples shard over
"spp" with the counter RNG: the rank renders samples [s * spp/n_spp, (s
+ 1) * spp/n_spp), and ``all_reduce`` over its "spp" column, divided by
n_spp, takes the place of JAX's ``psum``.

- ``sharded_render_frame`` returns the whole (3, H, W) frame on every
  rank, as JAX's global array: the ranks' rows are gathered over the
  world (``all_gather_into_tensor``, which gloo runs on CUDA tensors as
  well, staged through the host) and the blocks of one rank a "spp"
  column are stacked.
- ``sharded_render_frame_diff`` returns the rank's rows, differentiable:
  the spp ``all_reduce`` is an autograd Function whose backward
  all-reduces the cotangent (the transpose of a psum).
  ``sharded_image_loss`` all-reduces three partial sums (each pixel
  counted once, whatever n_spp is; its backward moves nothing), and
  ``sharded_loss_and_grad`` ends the step with one flat ``all_reduce`` of
  every parameter's gradient in key order: the psum that shard_map's
  transpose inserts in JAX. Every rank's loss and gradients are then the
  unsharded step's.

``comm_elements`` adds up the f32 elements every collective of this
module moves (``parallel/budget.py`` models one training step's).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from cpuperformanceraytracer_tpu_torch.config import resolve_device
from cpuperformanceraytracer_tpu_torch.diff.grad import (
    render_for_params,
    value_and_grad,
)
from cpuperformanceraytracer_tpu_torch.parallel.mesh import Mesh
from cpuperformanceraytracer_tpu_torch.render.frame import (
    accumulate_frame,
    frame_blend,
    make_frame_fn,
)
from cpuperformanceraytracer_tpu_torch.texture.texture import texture_to

comm_elements = 0

# all_gather_into_tensor under its newer torch name, where torch has it
_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` in place over ``group`` (the world by default)."""
    global comm_elements
    dist.all_reduce(t, group=group)
    comm_elements += t.numel()
    return t


def _all_gather(t: torch.Tensor, size: int) -> torch.Tensor:
    """Every rank's ``t`` (contiguous), stacked in rank order: (size,
    *t.shape)."""
    global comm_elements
    out = t.new_empty((size * t.shape[0], *t.shape[1:]))
    _gather_into(out, t)
    comm_elements += out.numel()
    return out.view(size, *t.shape)


class _SppSum(torch.autograd.Function):
    """psum over the rank's "spp" column; its transpose all-reduces the
    cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None


class _WorldSum(torch.autograd.Function):
    """Sum over the world of per-rank partials whose backward moves
    nothing: each rank differentiates its own partial."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g


def shard_window(cfg, mesh: Mesh, diff: bool = False) -> tuple:
    """(row0, local_height, spp_offset, spp_local) of this rank; raises
    on a config the mesh cannot shard (the JAX errors)."""
    n_px, n_spp = mesh.shape.get("px", 1), mesh.shape.get("spp", 1)
    if cfg.height % n_px:
        raise ValueError(f"height {cfg.height} not divisible by px shards {n_px}")
    if cfg.spp % n_spp:
        raise ValueError(f"spp {cfg.spp} not divisible by spp shards {n_spp}")
    if diff and cfg.rng != "counter":
        raise ValueError('sharded diff rendering requires rng="counter"')
    if n_spp > 1 and cfg.rng != "counter":
        raise ValueError('spp sharding requires rng="counter"')
    h, spp = cfg.height // n_px, cfg.spp // n_spp
    return mesh.px * h, h, mesh.spp * spp, spp


def _device(cfg, mesh: Mesh) -> torch.device:
    return resolve_device(cfg.backend, mesh.device)


def make_rows_fn(cfg, mesh: Mesh, scene, camera):
    """``rows(texture, frame, accum=None) -> (3, H/n_px, W)``: this rank's
    rows of one frame, the mean over all its "spp" column's samples.
    With ``accum`` (this rank's rows of an accumulator) the frame is
    accumulated into it in place (``frame_blend``) and returned; where
    spp is not sharded the frame's kernels accumulate it themselves, as
    on one device."""
    cfg = cfg.validate()
    row0, h, spp0, spp = shard_window(cfg, mesh)
    n_spp = mesh.shape.get("spp", 1)
    device = _device(cfg, mesh)
    step = make_frame_fn(cfg.replace(spp=spp), scene, camera, device,
                         row0=row0, local_height=h, spp_offset=spp0)

    def rows(texture, frame: int, accum=None) -> torch.Tensor:
        if accum is not None and n_spp == 1:
            return step(texture, frame, accum)
        color = torch.zeros((3, h, cfg.width), dtype=torch.float32,
                            device=device)
        step(texture, frame, color, 1.0)
        if n_spp > 1:
            color = _all_reduce(color, mesh.spp_group) / n_spp
        if accum is None:
            return color
        return accumulate_frame(accum, color, frame_blend(frame))

    return rows


def assemble_rows(rows: torch.Tensor, cfg, mesh: Mesh) -> torch.Tensor:
    """The whole (3, H, W) frame on every rank from each rank's rows (a
    collective: every rank calls it)."""
    if mesh.size == 1:
        return rows
    blocks = _all_gather(rows.contiguous(), mesh.size)
    # the ranks of a "spp" column hold the same rows: take the first's
    return (blocks[::mesh.shape.get("spp", 1)].transpose(0, 1)
            .reshape(3, cfg.height, cfg.width))


def sharded_render_frame(scene, camera, texture, cfg, frame,
                         mesh: Mesh) -> torch.Tensor:
    """One frame, sharded: rows over "px", samples over "spp"; the whole
    (3, H, W) frame on every rank. ``cfg.backend`` "cuda" and "torch"
    run kernel A (or its plain version) on the rank's window, then B, or
    E and F (blend 1 into a zeroed buffer: the colour's bits); "oracle"
    runs the oracle integrator on the window's fragCoords (JAX's ``xla``
    route)."""
    rows = make_rows_fn(cfg, mesh, scene, camera)
    if texture is not None:
        texture = texture_to(texture, _device(cfg.validate(), mesh))
    color = rows(texture, frame)
    return assemble_rows(color, cfg, mesh)


def make_sharded_frame_fn(cfg, mesh: Mesh):
    """The sharded progressive step ``(scene, camera, texture, frame,
    accum) -> accum``: ``accum`` is the whole (3, H, W) accumulator on
    every rank, updated in place (JAX donates it). The scene is packed
    once per scene and camera object."""
    cfg = cfg.validate()
    built = {}

    def step(scene, camera, texture, frame, accum):
        key = (id(scene), id(camera))
        if key not in built:
            built.clear()
            # the scene and camera stay referenced, so their ids stay theirs
            built[key] = (scene, camera, make_rows_fn(cfg, mesh, scene, camera))
        rows = built[key][2]
        if texture is not None:
            texture = texture_to(texture, accum.device)
        color = rows(texture, frame)
        return accumulate_frame(accum, assemble_rows(color, cfg, mesh),
                                frame_blend(frame))

    return step


def make_sharded_multi_frame_fn(cfg, mesh: Mesh, frames_per_dispatch: int):
    """K sharded progressive frames a call: ``(scene, camera, texture,
    frame0, accum) -> accum``, frames frame0 .. frame0 + K - 1. A loop of
    K sharded steps: JAX fuses them into one dispatch (``fori_loop``); a
    CUDA graph cannot hold gloo's collectives, and the forward frame's
    dispatch fusion is not ported (its idle share is under 1%)."""
    step = make_sharded_frame_fn(cfg, mesh)

    def step_k(scene, camera, texture, frame0, accum):
        for i in range(frames_per_dispatch):
            accum = step(scene, camera, texture, frame0 + i, accum)
        return accum

    return step_k


def _diff_rows(params, scene, camera, texture, cfg, frame, mesh: Mesh,
               quad_tbl=None) -> torch.Tensor:
    row0, h, spp0, spp = shard_window(cfg, mesh, diff=True)
    if cfg.backend == "oracle":
        raise ValueError("sharded diff rendering runs the kernel routes "
                         "(backend 'cuda' or 'torch')")
    color = render_for_params(params, scene, camera, texture,
                              cfg.replace(spp=spp), frame, quad_tbl=quad_tbl,
                              spp_offset=spp0, row0=row0, local_height=h)
    n_spp = mesh.shape.get("spp", 1)
    if n_spp > 1:
        color = _SppSum.apply(color, mesh.spp_group) / n_spp
    return color


def sharded_render_frame_diff(scene, camera, texture, cfg, frame,
                              mesh: Mesh) -> torch.Tensor:
    """Differentiable sharded frame: this rank's (3, H/n_px, W) rows, the
    mean over its "spp" column's samples (kernels A-D on the window, or
    their plain versions). Needs the counter RNG."""
    return _diff_rows({}, scene, camera, texture, cfg.validate(), frame, mesh)


def sharded_image_loss(a: torch.Tensor, b: torch.Tensor,
                       mesh: Mesh) -> torch.Tensor:
    """``diff.grad.image_loss`` over the whole image from each rank's rows
    ``a`` and ``b``: the per-channel sums of squares all-reduced over the
    world (every rank of a "spp" column holds the same rows, so the
    divisor counts each pixel n_spp times)."""
    partial = ((a - b) ** 2).sum(dim=(1, 2))
    n = a.shape[1] * a.shape[2] * mesh.size
    if mesh.size > 1:
        partial = _WorldSum.apply(partial)
    return (partial[0] / n + partial[1] / n + partial[2] / n) / 3.0


def allreduce_grads(grads: Dict, mesh: Mesh) -> Dict:
    """Sum every gradient over the world in one flat ``all_reduce``, keys
    in sorted order."""
    if mesh.size == 1:
        return grads
    keys = sorted(grads)
    flat = _all_reduce(torch.cat([grads[k].reshape(-1) for k in keys]))
    out = {}
    for k, part in zip(keys, torch.split(flat, [grads[k].numel() for k in keys])):
        out[k] = part.reshape(grads[k].shape)
    return out


def sharded_loss_and_grad(params: Dict, target: torch.Tensor, scene, camera,
                          texture, cfg, frame, mesh: Mesh, quad_tbl=None):
    """(loss, grads) of the L2 pixel loss against the whole (3, H, W)
    ``target``, sharded over ``mesh``: every rank gets the unsharded
    step's loss and gradients. ``quad_tbl`` as in
    ``diff.grad.render_for_params``."""
    cfg = cfg.validate()
    row0, h, _, _ = shard_window(cfg, mesh, diff=True)
    target = target[:, row0:row0 + h]

    def loss_fn(p):
        rows = _diff_rows(p, scene, camera, texture, cfg, frame, mesh,
                          quad_tbl)
        return sharded_image_loss(rows, target, mesh)

    loss, grads = value_and_grad(loss_fn, params)
    return loss, allreduce_grads(grads, mesh)
