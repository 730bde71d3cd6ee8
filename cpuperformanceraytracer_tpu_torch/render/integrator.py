"""The oracle integrator: intersection, material model and bounce loop in
plain PyTorch, vectorised over a flat pixel axis.

Counterpart of ``cpuperformanceraytracer_tpu.render.integrator``, the JAX
package's default ``backend="xla"`` route, and this port's
``backend="oracle"``. It is written from the reference's per-ray
formulation, not from kernel A: every ray tests every object at once (a
(P, N) tensor for P pixels and N objects) and takes the nearest hit with
a first-wins argmin over the object axis, quads before spheres, as the
reference's strictly-closer blend chain. Control flow is masking over a
fixed ``cfg.bounces + 1`` segments. Exact division and sqrt throughout
(the parity policy); a divisor that is a Python number is made a tensor,
because torch on CUDA multiplies by the reciprocal of a scalar divisor.

Draw-order contract (per bounce iteration, both RNG families, matching
the reference's unconditional consumption, so the oracle and kernel A
draw the same stream):
  1. env-map jitter: 2 draws iff (env texture and stochastic sampling)
  2. ray-select roll: 1 draw
  3. diffuse unit vector: 3 draws ("normalized3") or 2 ("zangle")
  4. refraction unit vector: same count
  5. roulette roll: 1 draw iff roulette != "off"

The env lookup is deferred to the end of the path: only the first miss's
direction, throughput and jitter reach the output. Unlike kernel A (one
set of miss planes per pixel), each sample does its own lookup, so the
oracle renders the wang RNG with spp > 1 and an env map.

``cfg.remat_bounces`` wraps each bounce in ``torch.utils.checkpoint``:
autograd keeps only each segment's input carry and replays the segment
in the backward sweep (``diff/path_replay.py``); the counter RNG's state
rides in the carry, so the replay draws the same numbers.

Not ported: ``unroll_bounces``, an XLA compile-time choice between a
rolled ``fori_loop`` and an unrolled loop; eager PyTorch runs the same
Python loop either way.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from cpuperformanceraytracer_tpu_torch.core.rng import (
    CounterRng,
    WangRng,
    frame_key,
)
from cpuperformanceraytracer_tpu_torch.core.sampling import unit_vector_sampler
from cpuperformanceraytracer_tpu_torch.core.vecmath import (
    Vec3,
    dot3,
    fresnel_reflect_amount,
    reflect,
    refract,
    safe_normalize,
    where3,
)
from cpuperformanceraytracer_tpu_torch.scene.types import Scene, precompute_quads
from cpuperformanceraytracer_tpu_torch.texture.texture import (
    env_draws_per_bounce,
    sample_environment_deferred,
)

MIN_RAY_HIT_TIME = 0.01
RAY_POS_NORMAL_NUDGE = 0.01
SUPER_FAR = 10000.0
MIN_RAY_PROBABILITY = 0.001


class MaterialSample(NamedTuple):
    """Per-ray material fields, each (P,)."""

    albedo: Vec3
    emissive: Vec3
    specular_chance: torch.Tensor
    specular_roughness: torch.Tensor
    specular_color: Vec3
    ior: torch.Tensor
    refraction_chance: torch.Tensor
    refraction_roughness: torch.Tensor
    refraction_color: Vec3


class Hit(NamedTuple):
    """Nearest-hit record, each (P,)."""

    dist: torch.Tensor
    normal: Vec3
    from_inside: torch.Tensor   # bool
    material_index: torch.Tensor  # int64


def _rays(v: Vec3) -> Vec3:
    """(P,) ray components as (P, 1), against (N,) object fields."""
    return Vec3(v.x[:, None], v.y[:, None], v.z[:, None])


def _pick(best: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """t[p, best[p]] of a (P, N) tensor."""
    return torch.gather(t, 1, best[:, None])[:, 0]


def fetch_material(scene: Scene, idx: torch.Tensor) -> MaterialSample:
    """The material fields of each ray's material index."""
    m = scene.materials

    def v(t: Vec3) -> Vec3:
        return Vec3(t.x[idx], t.y[idx], t.z[idx])

    return MaterialSample(
        albedo=v(m.albedo), emissive=v(m.emissive),
        specular_chance=m.specular_chance[idx],
        specular_roughness=m.specular_roughness[idx],
        specular_color=v(m.specular_color), ior=m.ior[idx],
        refraction_chance=m.refraction_chance[idx],
        refraction_roughness=m.refraction_roughness[idx],
        refraction_color=v(m.refraction_color))


def _test_quads(scene: Scene, derived, ray_pos: Vec3, ray_dir: Vec3):
    """All quads at once: the precomputed plane hit and the dual-edge
    inside test of both triangles, double-sided by flipping the normal.
    Returns (dist, normal, valid), each (P, NQ); dist = SUPER_FAR where
    not valid."""
    q, n = scene.quads, derived.normal
    pos, dir = _rays(ray_pos), _rays(ray_dir)
    ray_offset = q.v0 - pos
    denom = dot3(dir, n)
    denom_safe = torch.where(torch.abs(denom) < 1e-12,
                             torch.where(denom < 0, -1e-12, 1e-12), denom)
    dist = dot3(ray_offset, n) / denom_safe
    hit = dir * dist - ray_offset
    a0 = dot3(hit, derived.nxv01)
    a1 = dot3(hit, derived.nxv20)
    a2 = 1.0 - a0 - a1
    b0 = dot3(hit, derived.nxv30)
    b1 = dot3(hit, derived.nxv02)
    b2 = 1.0 - b0 - b1
    tri1 = (a0 >= 0.0) & (a1 >= 0.0) & (a2 >= 0.0)
    tri2 = (b0 >= 0.0) & (b1 >= 0.0) & (b2 >= 0.0)
    valid = (tri1 | tri2) & (dist > MIN_RAY_HIT_TIME) & (dist < SUPER_FAR)
    normal = where3(denom > 0.0, -n, n)
    dist = torch.where(valid, dist, SUPER_FAR)
    return dist, normal, valid


def _test_spheres(scene: Scene, ray_pos: Vec3, ray_dir: Vec3):
    """All spheres at once, with the from-inside case. Returns (dist,
    normal, from_inside, valid), each (P, NS)."""
    s = scene.spheres
    dir = _rays(ray_dir)
    m = _rays(ray_pos) - s.center
    b = dot3(m, dir)
    c = dot3(m, m) - s.radius * s.radius
    discr = b * b - c
    miss = ((c > 0.0) & (b > 0.0)) | (discr < 0.0)
    # the sqrt of a safe operand where discr <= 0: sqrt'(0) is inf, and a
    # later select would multiply that inf by a zero cotangent (NaN)
    sq = torch.where(discr > 0.0,
                     torch.sqrt(torch.where(discr > 0.0, discr, 1.0)), 0.0)
    from_inside = -b < sq
    dist = torch.where(from_inside, sq, -sq) - b
    valid = (~miss) & (dist > MIN_RAY_HIT_TIME) & (dist < SUPER_FAR)
    hit_rel = m + dir * dist
    sign = torch.where(from_inside, -1.0, 1.0)
    normal = safe_normalize(hit_rel) * sign
    dist = torch.where(valid, dist, SUPER_FAR)
    return dist, normal, from_inside & valid, valid


def trace_scene(scene: Scene, derived, ray_pos: Vec3, ray_dir: Vec3) -> Hit:
    """Nearest hit over all quads then all spheres; the first object wins
    an exact tie (argmin returns the first minimum)."""
    q_dist, q_normal, _ = _test_quads(scene, derived, ray_pos, ray_dir)
    s_dist, s_normal, s_inside, _ = _test_spheres(scene, ray_pos, ray_dir)
    dists = torch.cat([q_dist, s_dist], dim=1)
    best = torch.argmin(dists, dim=1)
    normals = [torch.cat([a, b], dim=1) for a, b in zip(q_normal, s_normal)]
    inside = torch.cat([torch.zeros_like(q_dist, dtype=torch.bool), s_inside],
                       dim=1)
    mats = torch.cat([scene.quads.material, scene.spheres.material])
    return Hit(dist=_pick(best, dists),
               normal=Vec3(*(_pick(best, t) for t in normals)),
               from_inside=_pick(best, inside), material_index=mats[best])


def color_for_ray(scene: Scene, derived, texture, cfg, start_pos: Vec3,
                  start_dir: Vec3, rng):
    """The bounce loop, ``cfg.bounces + 1`` segments with per-ray alive
    masks, then the deferred env lookup. The estimator weights (the
    lottery probability, the roulette boost) are detached. Roulette
    "v4_quirk" boosts survivors without terminating them, as the
    reference; "terminate" ends them. Returns (colour Vec3, rng)."""
    env_draws = env_draws_per_bounce(texture, cfg)
    unit_vector = unit_vector_sampler(cfg.unit_vector_sampler)
    zeros = torch.zeros_like(start_dir.x)

    def bounce_body(ret, thr, pos, dir, alive, miss_state, rng):
        hit = trace_scene(scene, derived, pos, dir)
        # the env jitter is drawn every iteration (the stream contract);
        # the lookup itself waits for the end of the path
        if env_draws:
            jr, rng = rng.next01()
            jc, rng = rng.next01()
        else:
            jr = jc = zeros
        miss = hit.dist >= SUPER_FAR
        first_miss = alive & miss
        update = alive & ~miss
        miss_dir, miss_thr, miss_jr, miss_jc, missed = miss_state
        miss_state = (where3(first_miss, dir, miss_dir),
                      where3(first_miss, thr, miss_thr),
                      torch.where(first_miss, jr, miss_jr),
                      torch.where(first_miss, jc, miss_jc),
                      missed | first_miss)

        mat = fetch_material(scene, hit.material_index)
        dist = torch.where(miss, 0.0, hit.dist)
        rc = mat.refraction_color
        absorb = Vec3(torch.exp(-rc.x * dist), torch.exp(-rc.y * dist),
                      torch.exp(-rc.z * dist))
        new_thr = where3(hit.from_inside, thr * absorb, thr)

        spec_chance = mat.specular_chance
        refr_chance = mat.refraction_chance
        has_spec = spec_chance > 0.0
        n1 = torch.where(hit.from_inside, mat.ior, 1.0)
        n2 = torch.where(hit.from_inside, 1.0, mat.ior)
        fresnel_spec = fresnel_reflect_amount(n1, n2, hit.normal, dir,
                                              mat.specular_chance, 1.0)
        chance_mult = (1.0 - fresnel_spec) / torch.clamp(
            1.0 - mat.specular_chance, min=1e-6)
        spec_chance = torch.where(has_spec, fresnel_spec, spec_chance)
        refr_chance = torch.where(has_spec, refr_chance * chance_mult,
                                  refr_chance)

        roll, rng = rng.next01()
        do_spec = (spec_chance > 0.0) & (roll < spec_chance)
        do_refr = (~do_spec) & (refr_chance > 0.0) & (
            roll < spec_chance + refr_chance)
        diff_chance = torch.clamp(1.0 - (spec_chance + refr_chance), min=0.0)
        ray_prob = torch.where(do_spec, spec_chance,
                               torch.where(do_refr, refr_chance, diff_chance))
        ray_prob = torch.clamp(ray_prob, min=MIN_RAY_PROBABILITY).detach()

        nudge_sign = torch.where(do_refr, -1.0, 1.0)
        new_pos = pos + dir * dist + hit.normal * (RAY_POS_NORMAL_NUDGE
                                                   * nudge_sign)

        unit_d, rng = unit_vector(rng)
        diffuse_dir = safe_normalize(hit.normal + unit_d)
        spec_dir = reflect(dir, hit.normal)
        spec_rough2 = mat.specular_roughness * mat.specular_roughness
        spec_dir = spec_dir + (diffuse_dir - spec_dir) * spec_rough2
        eta = torch.where(hit.from_inside, mat.ior, 1.0 / mat.ior)
        refr_dir = refract(dir, hit.normal, eta)
        unit_r, rng = unit_vector(rng)
        refr_target = safe_normalize(unit_r - hit.normal)
        refr_rough2 = mat.refraction_roughness * mat.refraction_roughness
        refr_dir = refr_dir + (refr_target - refr_dir) * refr_rough2
        new_dir = safe_normalize(
            where3(do_spec, spec_dir, where3(do_refr, refr_dir, diffuse_dir)))

        new_ret = ret + mat.emissive * new_thr
        color_factor = where3(do_spec, mat.specular_color, mat.albedo)
        new_thr = where3(do_refr, new_thr, new_thr * color_factor)
        new_thr = new_thr * (1.0 / ray_prob)

        if cfg.roulette != "off":
            p = torch.clamp(torch.maximum(new_thr.x, torch.maximum(
                new_thr.y, new_thr.z)), 0.0, 1.0)
            rr, rng = rng.next01()
            terminated = rr > p
            boost = 1.0 / torch.clamp(p, min=MIN_RAY_PROBABILITY).detach()
            new_thr = where3(terminated, new_thr, new_thr * boost)
            if cfg.roulette == "terminate":
                update = update & ~terminated

        return (where3(update, new_ret, ret), where3(update, new_thr, thr),
                where3(update, new_pos, pos), where3(update, new_dir, dir),
                update, miss_state, rng)

    body = bounce_body
    if cfg.remat_bounces:
        def body(*carry):
            return checkpoint(bounce_body, *carry, use_reentrant=False,
                              preserve_rng_state=False)

    miss_state = (Vec3(zeros, zeros, zeros + 1.0), Vec3(zeros, zeros, zeros),
                  zeros, zeros, torch.zeros_like(zeros, dtype=torch.bool))
    carry = (Vec3(zeros, zeros, zeros), Vec3(zeros + 1.0, zeros + 1.0,
                                             zeros + 1.0),
             start_pos, start_dir, torch.ones_like(zeros, dtype=torch.bool),
             miss_state, rng)
    for _ in range(cfg.bounces + 1):
        carry = body(*carry)
    ret, _, _, _, _, miss_state, rng = carry
    miss_dir, miss_thr, miss_jr, miss_jc, missed = miss_state
    env = sample_environment_deferred(texture, miss_dir, cfg, miss_jr, miss_jc)
    return where3(missed, ret + env * miss_thr, ret), rng


def camera_ray(camera, x, y, width: int, height: int, rng, jitter: bool):
    """Primary rays for the (P,) fragCoords (x, y): sub-pixel jitter in
    [-.5, .5)^2 (2 draws iff ``jitter``), the NDC target on the z =
    forward_z * distance plane, y scaled by height/width (rounded once
    from float64). Returns (origin, direction, rng), each (P,)."""
    if jitter:
        jx, rng = rng.next01()
        jy, rng = rng.next01()
        fx, fy = x + (jx - 0.5), y + (jy - 0.5)
    else:
        fx, fy = x, y
    u = (fx / torch.full_like(fx, float(width))) * 2.0 - 1.0
    v = (fy / torch.full_like(fy, float(height))) * 2.0 - 1.0
    v = v * float(np.float32(height / width))
    zeros = torch.zeros_like(u)
    target = Vec3(u, v, zeros + camera.forward_z * camera.distance)
    origin = Vec3(*(zeros + p for p in camera.position))
    return origin, safe_normalize(target), rng


def render_pixel(scene: Scene, camera, texture, cfg, x, y, frame,
                 spp_offset: int = 0, spp_count=None) -> Vec3:
    """The (P,) pixels at fragCoords (x, y), ``spp_count`` (default
    ``cfg.spp``) samples averaged; ``frame`` (an int or a ``DeviceFrame``)
    is the accumulation index and the RNG epoch.

    wang: one sequential stream per (pixel, frame), shared by the jitter
    and all samples, as the reference. counter: one addressable stream
    per (pixel, frame, sample), the jitter drawn again for each sample;
    ``spp_offset`` names the first sample."""
    if spp_count is None:
        spp_count = cfg.spp
    xi, yi = x.to(torch.int64), y.to(torch.int64)
    frame = frame_key(frame)
    derived = precompute_quads(scene.quads)
    zeros = torch.zeros_like(x)
    color = Vec3(zeros, zeros, zeros)
    if cfg.rng == "wang":
        rng = WangRng.from_pixel(xi, yi, frame)
        origin, direction, rng = camera_ray(camera, x, y, cfg.width,
                                            cfg.height, rng, cfg.jitter)
        for _ in range(spp_count):
            c, rng = color_for_ray(scene, derived, texture, cfg, origin,
                                   direction, rng)
            color = color + c * (1.0 / spp_count)
        return color
    for s in range(spp_count):
        rng = CounterRng.from_pixel(xi, yi, frame, spp_offset + s)
        origin, direction, rng = camera_ray(camera, x, y, cfg.width,
                                            cfg.height, rng, cfg.jitter)
        c, _ = color_for_ray(scene, derived, texture, cfg, origin, direction,
                             rng)
        color = color + c
    return color * (1.0 / spp_count)


def to_device(tree, device):
    """A scene, camera (or a tuple of them: nested named tuples of
    tensors) with every tensor on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple):
        items = (to_device(t, device) for t in tree)
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def frag_coords(cfg, device, row0: int = 0, local_height=None) -> tuple:
    """Flat (P,) f32 fragCoords of global rows [row0, row0 +
    local_height) (all rows by default), row-major from the top-left
    pixel (the fragCoord y of a row is H-1-row)."""
    if local_height is None:
        local_height = cfg.height - row0
    cols = torch.arange(cfg.width, dtype=torch.float32, device=device)
    rows = torch.arange(row0, row0 + local_height, dtype=torch.float32,
                        device=device)
    fy, fx = torch.meshgrid((cfg.height - 1) - rows, cols, indexing="ij")
    return fx.reshape(-1), fy.reshape(-1)


def render_frame(scene: Scene, camera, texture, cfg, frame, row0: int = 0,
                 local_height=None, spp_offset: int = 0) -> torch.Tensor:
    """One frame of ``cfg.spp`` samples from sample ``spp_offset`` for
    every pixel of global rows [row0, row0 + local_height) (the whole
    image by default): (3, local_height, W) f32 on the scene's device.
    The window and the offset are the JAX sharded ``xla`` route's
    (``parallel/shard.py``)."""
    fx, fy = frag_coords(cfg, scene.materials.ior.device, row0, local_height)
    color = render_pixel(scene, camera, texture, cfg, fx, fy, frame,
                         spp_offset=spp_offset)
    return torch.stack(list(color)).reshape(3, -1, cfg.width)
