"""Kernel A: the forward path-tracing megakernel, and its plain version.

Replaces ``cpuperformanceraytracer_tpu/kernels/megakernel.py::_make_kernel``
(dispatched by ``_pallas_render``). Per pixel it seeds the RNG, casts a
jittered camera ray and runs ``bounces+1`` segments of the bounce body:
nearest hit over every quad (two-triangle dual-edge test) and sphere,
material fetch, the Fresnel specular/refraction/diffuse lottery, Beer
absorption, emissive, and Russian roulette. The env lookup is deferred:
the kernel emits 12 (H, W) f32 planes in this order

    r, g, b, miss_dir xyz, miss_thr xyz, jr, jc, missed

and kernel B (``env_accumulate``) resolves them. With env_mode "none"
the ambient is added inline at the first miss.

The scene reaches the kernel as four f32 tables, its ABI (the same
tables as the JAX ``pack_scene``/``pack_camera``):

    quad_tbl (NQ, 25): v0, normal, nxv01, nxv12, nxv20, nxv02, nxv23,
                       nxv30 (3 each), material index
    sph_tbl  (NS, 5):  center (3), radius, material index
    mat_tbl  (NM, 17): albedo (3), emissive (3), specular chance,
                       specular roughness, specular color (3), ior,
                       refraction chance, refraction roughness,
                       refraction color (3)
    cam_tbl  (8,):     position (3), distance, forward_z, ambient (3)

Two formulas follow the JAX main path, which bakes a concrete scene
into the kernel: the sphere normal is ``hit_rel * (sgn * (1/r))`` with
1/r rounded from float64 (as a Python constant is), and the image
aspect ``height/width`` is rounded from float64.

On the card the kernel is persistent and regenerates paths: a lane whose
pixel has ended takes the next pixel, so a warp's lanes stay busy while
its paths end at different segments (``csrc/megakernel.cu``).
``RenderConfig.early_exit`` is kept for parity with the JAX config and
changes nothing: a path that ends frees its lane.

``render_planes`` is the wrapper: a CPU tensor takes the plain version,
a CUDA tensor launches ``csrc/megakernel.cu`` (and counts the launch in
``render_planes.launches``); any other device raises.

A launch renders a window of pixel rows, ``row0`` and ``local_height``
(the whole image by default): (12, local_height, W) planes of global
rows [row0, row0 + local_height), each pixel keyed and cast from its
global row, so a window is bit-equal to those rows of the whole image.
This is the JAX kernel's ``row0``/``local_height`` under shard_map
(``parallel/shard.py`` passes them; ``sample0`` is its ``spp_offset``).

The frame index is an int, or a ``core.rng.DeviceFrame``: ``base[0] +
offset`` with ``base`` a (1,) int32 tensor that the kernel reads on the
device. A CUDA graph bakes the offset in and replays with the frame the
host wrote into ``base`` (``diff/graph.py``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from cpuperformanceraytracer_tpu_torch.core.rng import (
    CounterRng,
    DeviceFrame,
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
from cpuperformanceraytracer_tpu_torch.kernels._build import check, load_library
from cpuperformanceraytracer_tpu_torch.scene.types import precompute_quads
from cpuperformanceraytracer_tpu_torch.utils.profiling import count_launch

QUAD_COLS = 25
SPH_COLS = 5
MAT_COLS = 17
CAM_COLS = 8
N_PLANES = 12

MIN_RAY_HIT_TIME = 0.01
RAY_POS_NORMAL_NUDGE = 0.01
SUPER_FAR = 10000.0
MIN_RAY_PROBABILITY = 0.001

_ROULETTE = {"off": 0, "terminate": 1, "v4_quirk": 2}


def frame_args(frame, device) -> tuple:
    """(offset, base pointer or None) of a frame for a kernel launch."""
    if not isinstance(frame, DeviceFrame):
        return int(frame), None
    base = frame.base
    if (base.shape != (1,) or base.dtype != torch.int32
            or base.device != device):
        raise ValueError(f"DeviceFrame base must be (1,) int32 on {device}, "
                         f"got {tuple(base.shape)} {base.dtype} {base.device}")
    return int(frame.offset), base.data_ptr()


def _cat3(v):
    return [v.x, v.y, v.z]


def pack_quads(q) -> torch.Tensor:
    """Quads -> (NQ, 25) quad table f32."""
    d = precompute_quads(q)
    return torch.stack(
        _cat3(q.v0) + _cat3(d.normal) + _cat3(d.nxv01) + _cat3(d.nxv12)
        + _cat3(d.nxv20) + _cat3(d.nxv02) + _cat3(d.nxv23) + _cat3(d.nxv30)
        + [q.material.to(torch.float32)], dim=-1)


def pack_scene(scene, quad_tbl=None):
    """Scene -> (quad_tbl, sph_tbl, mat_tbl) f32 on the scene's device.
    A caller that packs the same quads every step passes their table,
    derived once (``pack_quads``: some 130 small kernels)."""
    if quad_tbl is None:
        quad_tbl = pack_quads(scene.quads)
    s = scene.spheres
    sph_tbl = torch.stack(
        _cat3(s.center) + [s.radius, s.material.to(torch.float32)], dim=-1)
    m = scene.materials
    mat_tbl = torch.stack(
        _cat3(m.albedo) + _cat3(m.emissive)
        + [m.specular_chance, m.specular_roughness]
        + _cat3(m.specular_color)
        + [m.ior, m.refraction_chance, m.refraction_roughness]
        + _cat3(m.refraction_color), dim=-1)
    return quad_tbl, sph_tbl, mat_tbl


def pack_camera(camera, cfg) -> torch.Tensor:
    """(8,) camera table; the ambient rides along for env_mode 'none'. The
    ambient is filled on the camera's device: a copy from host memory
    would synchronise the stream on every training step."""
    p = camera.position
    amb = [camera.distance.new_full((), a) for a in cfg.ambient]
    return torch.stack([p.x, p.y, p.z, camera.distance, camera.forward_z,
                        *amb])


def pack_tables(scene, camera, cfg, device):
    """All four kernel tables, contiguous f32 on ``device``."""
    tables = (*pack_scene(scene), pack_camera(camera, cfg))
    return tuple(t.to(device=device, dtype=torch.float32).contiguous()
                 for t in tables)


def _aspect(cfg) -> float:
    """height/width rounded once from float64 to f32."""
    return float(np.float32(cfg.height / cfg.width))


def _inv_spp(cfg) -> float:
    return float(np.float32(1.0 / cfg.spp))


def window(cfg, row0: int = 0, local_height=None) -> tuple:
    """(row0, local_height) of a pixel-row window of ``cfg``'s image,
    checked; ``local_height`` None is the rest of the image."""
    row0 = int(row0)
    local_height = cfg.height - row0 if local_height is None else int(local_height)
    if row0 < 0 or local_height < 0 or row0 + local_height > cfg.height:
        raise ValueError(f"row window [{row0}, {row0 + local_height}) is not "
                         f"inside the image's {cfg.height} rows")
    return row0, local_height


def render_planes_reference(tables, cfg, frame, sample0: int = 0,
                            live_segments=None, row0: int = 0,
                            local_height=None) -> torch.Tensor:
    """Plain-torch kernel A: the per-object blend chain of the TPU
    kernel, vectorised over all pixels, every segment run with dead
    paths masked (the kernel's early exit does not change the output).
    Returns (12, local_height, W) f32 on the tables' device: global rows
    [row0, row0 + local_height) of the image (all of it by default),
    each pixel keyed and cast from its global row. A list passed as
    ``live_segments`` receives the number of live paths at the start of
    each segment (the segments the kernel runs)."""
    quad_tbl, sph_tbl, mat_tbl, cam_tbl = tables
    dev = quad_tbl.device
    frame = frame_key(frame)
    row0, h = window(cfg, row0, local_height)
    w = cfg.width
    row = torch.arange(row0, row0 + h, device=dev,
                       dtype=torch.int64)[:, None].expand(h, w)
    col = torch.arange(w, device=dev, dtype=torch.int64)[None, :].expand(h, w)
    fy_i = (cfg.height - 1) - row
    frag_x = col.to(torch.float32)
    frag_y = fy_i.to(torch.float32)
    zeros = torch.zeros((h, w), dtype=torch.float32, device=dev)
    ones = torch.ones_like(zeros)

    quads = [(Vec3(*q[0:3]), Vec3(*q[3:6]), Vec3(*q[6:9]), Vec3(*q[12:15]),
              Vec3(*q[15:18]), Vec3(*q[21:24]), q[24]) for q in quad_tbl]
    inv_r = (1.0 / sph_tbl[:, 3].double()).float()
    spheres = [(Vec3(*s[0:3]), s[3], inv_r[i], s[4])
               for i, s in enumerate(sph_tbl)]
    env_draws = cfg.env_mode != "none" and cfg.env_sampling == "stochastic"
    unit_vec = unit_vector_sampler(cfg.unit_vector_sampler)
    aspect = _aspect(cfg)

    def trace(pos, dir):
        best = torch.full((h, w), SUPER_FAR, device=dev)
        normal = Vec3(zeros, zeros, ones)
        inside = torch.zeros((h, w), dtype=torch.bool, device=dev)
        mat = zeros
        for v0, n, nxv01, nxv20, nxv02, nxv30, mq in quads:
            ray_off = v0 - pos
            dn = dot3(dir, n)
            denom = torch.where(torch.abs(dn) < 1e-12,
                                torch.where(dn < 0, -1e-12, 1e-12), dn)
            dist = dot3(ray_off, n) / denom
            hitp = dir * dist - ray_off
            a0, a1 = dot3(hitp, nxv01), dot3(hitp, nxv20)
            b0, b1 = dot3(hitp, nxv30), dot3(hitp, nxv02)
            tri1 = (a0 >= 0.0) & (a1 >= 0.0) & (1.0 - a0 - a1 >= 0.0)
            tri2 = (b0 >= 0.0) & (b1 >= 0.0) & (1.0 - b0 - b1 >= 0.0)
            valid = (tri1 | tri2) & (dist > MIN_RAY_HIT_TIME) & (dist < best)
            qn = where3(dn > 0.0, -n, n)
            best = torch.where(valid, dist, best)
            normal = where3(valid, qn, normal)
            mat = torch.where(valid, mq, mat)
        for c, r, ir, ms in spheres:
            m_ = pos - c
            b = dot3(m_, dir)
            cc = dot3(m_, m_) - r * r
            discr = b * b - cc
            miss = ((cc > 0.0) & (b > 0.0)) | (discr < 0.0)
            sq = torch.where(discr > 0.0,
                             torch.sqrt(torch.where(discr > 0.0, discr, 1.0)),
                             0.0)
            from_in = -b < sq
            dist = torch.where(from_in, sq, -sq) - b
            valid = (~miss) & (dist > MIN_RAY_HIT_TIME) & (dist < best)
            hit_rel = m_ + dir * dist
            sgn = torch.where(from_in, -1.0, 1.0)
            sn = hit_rel * (sgn * ir)
            best = torch.where(valid, dist, best)
            normal = where3(valid, sn, normal)
            inside = (valid & from_in) | (~valid & inside)
            mat = torch.where(valid, ms, mat)
        return best, normal, inside, mat

    def bounce(s):
        rng = s["rng"]
        pos, dir, thr, ret, alive = s["pos"], s["dir"], s["thr"], s["ret"], s["alive"]
        dist, normal, inside, mat_idx = trace(pos, dir)
        if env_draws:
            jr, rng = rng.next01()
            jc, rng = rng.next01()
        else:
            jr = jc = zeros
        miss = dist >= SUPER_FAR
        first_miss = alive & miss
        update = alive & ~miss
        if cfg.env_mode == "none":
            ret = where3(first_miss, ret + Vec3(*cam_tbl[5:8]) * thr, ret)
        s["miss_dir"] = where3(first_miss, dir, s["miss_dir"])
        s["miss_thr"] = where3(first_miss, thr, s["miss_thr"])
        s["jr"] = torch.where(first_miss, jr, s["jr"])
        s["jc"] = torch.where(first_miss, jc, s["jc"])
        s["missed"] = s["missed"] | first_miss

        f = mat_tbl[mat_idx.to(torch.int64)].unbind(-1)
        albedo, emissive = Vec3(*f[0:3]), Vec3(*f[3:6])
        spec_ch, spec_rough, spec_color = f[6], f[7], Vec3(*f[8:11])
        ior, refr_ch, refr_rough = f[11], f[12], f[13]
        refr_color = Vec3(*f[14:17])

        d_safe = torch.where(miss, 0.0, dist)
        new_thr = where3(inside, Vec3(
            thr.x * torch.exp(-refr_color.x * d_safe),
            thr.y * torch.exp(-refr_color.y * d_safe),
            thr.z * torch.exp(-refr_color.z * d_safe)), thr)

        has_spec = spec_ch > 0.0
        n1 = torch.where(inside, ior, 1.0)
        n2 = torch.where(inside, 1.0, ior)
        fres = fresnel_reflect_amount(n1, n2, normal, dir, spec_ch, 1.0)
        chance_mult = (1.0 - fres) / torch.clamp(1.0 - spec_ch, min=1e-6)
        spec_chance = torch.where(has_spec, fres, spec_ch)
        refr_chance = torch.where(has_spec, refr_ch * chance_mult, refr_ch)

        roll, rng = rng.next01()
        do_spec = (spec_chance > 0.0) & (roll < spec_chance)
        do_refr = (~do_spec) & (refr_chance > 0.0) & (
            roll < spec_chance + refr_chance)
        diff_chance = torch.clamp(1.0 - (spec_chance + refr_chance), min=0.0)
        ray_prob = torch.where(do_spec, spec_chance,
                               torch.where(do_refr, refr_chance, diff_chance))
        # estimator weights, not physics: detached, as the JAX bounce body
        # (megakernel.py:590-597, :650-652) and the policy of diff/grad.py
        inv_prob = 1.0 / torch.clamp(ray_prob, min=MIN_RAY_PROBABILITY).detach()

        nudge = torch.where(do_refr, -RAY_POS_NORMAL_NUDGE,
                            RAY_POS_NORMAL_NUDGE)
        new_pos = pos + dir * d_safe + normal * nudge

        unit_d, rng = unit_vec(rng)
        diffuse_dir = safe_normalize(normal + unit_d)
        spec_dir = reflect(dir, normal)
        spec_dir = spec_dir + (diffuse_dir - spec_dir) * (spec_rough * spec_rough)
        unit_r, rng = unit_vec(rng)  # drawn even where unused (stream contract)
        eta = torch.where(inside, ior, 1.0 / ior)
        refr_dir = refract(dir, normal, eta)
        refr_target = safe_normalize(unit_r - normal)
        refr_dir = refr_dir + (refr_target - refr_dir) * (refr_rough * refr_rough)
        new_dir = safe_normalize(
            where3(do_spec, spec_dir, where3(do_refr, refr_dir, diffuse_dir)))

        new_ret = ret + emissive * new_thr
        color_factor = where3(do_spec, spec_color, albedo)
        new_thr = where3(do_refr, new_thr, new_thr * color_factor)
        new_thr = new_thr * inv_prob

        if cfg.roulette != "off":
            p = torch.clamp(torch.maximum(new_thr.x, torch.maximum(
                new_thr.y, new_thr.z)), 0.0, 1.0)
            rr, rng = rng.next01()
            terminated = rr > p
            boost = 1.0 / torch.clamp(p, min=MIN_RAY_PROBABILITY).detach()
            new_thr = where3(terminated, new_thr, new_thr * boost)
            if cfg.roulette == "terminate":
                update = update & ~terminated

        s.update(ret=where3(update, new_ret, ret),
                 thr=where3(update, new_thr, thr),
                 pos=where3(update, new_pos, pos),
                 dir=where3(update, new_dir, dir),
                 alive=update, rng=rng)

    def camera_ray(rng):
        if cfg.jitter:
            jx, rng = rng.next01()
            jy, rng = rng.next01()
            fx, fy = frag_x + (jx - 0.5), frag_y + (jy - 0.5)
        else:
            fx, fy = frag_x, frag_y
        # tensor divisors: on CUDA torch divides by a Python scalar as a
        # multiply by its reciprocal, which is not the kernel's division
        u = (fx / torch.full_like(fx, float(w))) * 2.0 - 1.0
        v = ((fy / torch.full_like(fy, float(cfg.height))) * 2.0 - 1.0) * aspect
        pos = Vec3(zeros + cam_tbl[0], zeros + cam_tbl[1], zeros + cam_tbl[2])
        target = Vec3(u, v, zeros + cam_tbl[4] * cam_tbl[3])
        return pos, safe_normalize(target), rng

    def sample(rng, pos, dir):
        s = dict(ret=Vec3(zeros, zeros, zeros), thr=Vec3(ones, ones, ones),
                 pos=pos, dir=dir, rng=rng,
                 alive=torch.ones((h, w), dtype=torch.bool, device=dev),
                 missed=torch.zeros((h, w), dtype=torch.bool, device=dev),
                 miss_dir=Vec3(zeros, zeros, ones),
                 miss_thr=Vec3(zeros, zeros, zeros), jr=zeros, jc=zeros)
        for _ in range(cfg.bounces + 1):
            if live_segments is not None:
                live_segments.append(int(s["alive"].sum()))
            bounce(s)
        return s

    acc = Vec3(zeros, zeros, zeros)
    inv_spp = _inv_spp(cfg)
    if cfg.rng == "wang":
        # the jittered ray is drawn once per frame and shared by the spp
        # loop, whose samples continue one sequential stream
        rng = WangRng.from_pixel(col, fy_i, frame)
        pos, dir, rng = camera_ray(rng)
        for _ in range(cfg.spp):
            s = sample(rng, pos, dir)
            rng = s["rng"]
            acc = acc + s["ret"] * inv_spp
    else:
        for k in range(cfg.spp):
            rng = CounterRng.from_pixel(col, fy_i, frame, sample0 + k)
            pos, dir, rng = camera_ray(rng)
            s = sample(rng, pos, dir)
            acc = acc + s["ret"] * inv_spp

    md, mt = s["miss_dir"], s["miss_thr"]
    return torch.stack([acc.x, acc.y, acc.z, md.x, md.y, md.z,
                        mt.x, mt.y, mt.z, s["jr"], s["jc"],
                        s["missed"].to(torch.float32)])


def _check_tables(tables):
    shapes = [(QUAD_COLS,), (SPH_COLS,), (MAT_COLS,), ()]
    dev = tables[0].device
    for t, tail in zip(tables, shapes):
        if (t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous()
                or (tail and (t.dim() != 2 or t.shape[1:] != tail))):
            raise ValueError(
                "kernel tables must be contiguous f32 on one device with "
                f"shapes (NQ,25), (NS,5), (NM,17), (8,); got "
                f"{[(tuple(x.shape), x.dtype, str(x.device)) for x in tables]}")
    if tables[3].shape != (CAM_COLS,):
        raise ValueError(f"cam_tbl must be (8,), got {tuple(tables[3].shape)}")


def render_planes(tables, cfg, frame, sample0: int = 0,
                  out=None, lane_stats=None, row0: int = 0,
                  local_height=None) -> torch.Tensor:
    """Kernel A wrapper: (12, local_height, W) f32 planes for one frame
    (an int or a ``DeviceFrame``) of global rows [row0, row0 +
    local_height) (the whole image by default), written into
    ``out`` when given (a contiguous (12, local_height, W) f32 tensor,
    e.g. one sample's slot of a (spp, 12, H, W) buffer). ``lane_stats``, a zeroed
    (2,) int64 tensor on the card, receives the lanes that ran a bounce
    segment and the lane slots of all the kernel's warp iterations (their
    ratio is its lane utilisation); the CPU path ignores it."""
    quad_tbl, sph_tbl, mat_tbl, cam_tbl = tables
    if quad_tbl.device.type == "cpu":
        planes = render_planes_reference(tables, cfg, frame, sample0,
                                         row0=row0, local_height=local_height)
        return planes if out is None else out.copy_(planes)
    if quad_tbl.device.type != "cuda":
        raise ValueError(f"render_planes: unsupported device {quad_tbl.device}")
    _check_tables(tables)
    row0, local_height = window(cfg, row0, local_height)
    nq, ns, nm = quad_tbl.shape[0], sph_tbl.shape[0], mat_tbl.shape[0]
    shape = (N_PLANES, local_height, cfg.width)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=quad_tbl.device)
    elif (out.shape != shape or out.dtype != torch.float32
          or not out.is_contiguous() or out.device != quad_tbl.device):
        raise ValueError(f"render_planes: out {tuple(out.shape)} {out.dtype} "
                         f"{out.device}, want {shape} contiguous f32")
    if lane_stats is not None and (
            lane_stats.shape != (2,) or lane_stats.dtype != torch.int64
            or lane_stats.device != quad_tbl.device):
        raise ValueError(f"render_planes: lane_stats {tuple(lane_stats.shape)} "
                         f"{lane_stats.dtype} {lane_stats.device}, want (2,) "
                         "int64 on the tables' device")
    env_draws = cfg.env_mode != "none" and cfg.env_sampling == "stochastic"
    offset, base = frame_args(frame, quad_tbl.device)
    per_sm, sms = _resident(quad_tbl.device.index or 0, nq, ns, nm)
    # the persistent kernel's work counter, zeroed on the stream by the
    # entry point before the launch (a memset node in a CUDA graph)
    counter = torch.empty(1, dtype=torch.int32, device=quad_tbl.device)
    stream = torch.cuda.current_stream(quad_tbl.device).cuda_stream
    err = load_library().cprt_render_planes(
        quad_tbl.data_ptr(), nq, sph_tbl.data_ptr(), ns, mat_tbl.data_ptr(),
        nm, cam_tbl.data_ptr(), out.data_ptr(), cfg.width, cfg.height,
        row0, local_height, offset, int(sample0), cfg.spp, cfg.bounces,
        int(cfg.rng == "counter"), int(env_draws),
        int(cfg.env_mode == "none"), _ROULETTE[cfg.roulette],
        int(cfg.unit_vector_sampler == "zangle"), int(cfg.jitter),
        ctypes.c_float(_aspect(cfg)), ctypes.c_float(_inv_spp(cfg)),
        counter.data_ptr(),
        None if lane_stats is None else lane_stats.data_ptr(), base,
        per_sm * sms, stream)
    check(err, "render_planes")
    count_launch(render_planes)
    return out


render_planes.launches = 0


@functools.lru_cache(maxsize=None)
def _resident(device_index: int, nq: int, ns: int, nm: int) -> tuple:
    """The occupancy query, once per card and table sizes (so a CUDA graph
    capture of a later launch runs none)."""
    per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        check(load_library().cprt_render_planes_resident(
            nq, ns, nm, ctypes.byref(per_sm), ctypes.byref(sms)),
            "resident_blocks")
    return per_sm.value, sms.value


def resident_blocks(tables) -> tuple:
    """(blocks per SM, SMs): the persistent kernel A's grid on the tables'
    card is their product (fewer blocks when the frame is smaller)."""
    return _resident(tables[0].device.index or 0, tables[0].shape[0],
                     tables[1].shape[0], tables[2].shape[0])


PLANE_NAMES = ("r", "g", "b", "md_x", "md_y", "md_z", "mt_x", "mt_y",
               "mt_z", "jr", "jc", "missed")
_MISS_STATE = {"md_x", "md_y", "md_z", "jr", "jc"}


def plane_mismatch(got: torch.Tensor, want: torch.Tensor,
                   atol: float = 1e-3) -> dict:
    """Per plane, the share of pixels on which two (12, H, W) plane stacks
    differ by more than ``atol``.

    The miss direction and the env jitter are compared on the pixels
    whose ``missed`` flags agree (a pixel that missed on one side only
    holds the defaults on the other, and counts once, under ``missed``).
    This is the parity measure for the lottery-driven glass scene, where
    a 1-ulp transcendental difference may flip one path.
    """
    got, want = got.double(), want.double()
    agree = got[11] == want[11]
    off = {}
    for i, name in enumerate(PLANE_NAMES):
        bad = (got[i] - want[i]).abs() > atol
        if name in _MISS_STATE:
            bad = bad[agree]
        off[name] = bad.double().mean().item() if bad.numel() else 0.0
    return off
