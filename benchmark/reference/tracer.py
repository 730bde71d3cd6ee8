"""The plain reference of the path tracer: scene tables, the bounce loop,
the equirect env lookup, the frame's colour and the progressive
accumulate, in plain PyTorch.

A frozen copy of the tracer's semantics, independent of the program it
judges: it imports nothing of the program and derives everything it
needs (the kernel tables, the camera rays, the env indices) from the
inputs the benchmark made. Per pixel a path runs ``bounces + 1``
segments: the nearest hit over every quad (two-triangle dual-edge test)
and sphere, the Fresnel specular / refraction / diffuse lottery, Beer
absorption, emission and Russian roulette; the first miss's direction,
throughput and env jitter are kept and the env map is looked up once per
path (one stochastic tap of an equirect map). Estimator weights (the
lottery's and the roulette's probabilities) are detached, so autograd
through this file gives the gradient policy of the program's adjoint.

Every float is computed in ``dtype``: float32 is the reference, and
bfloat16 the lower-precision control that the comparison has to fail.

The scene is a dict of tensors (see ``tables``); ``opts`` a dict of the
render settings: width, height, spp, bounces, rng ("wang" or "counter"),
roulette ("off", "terminate", "v4_quirk"), unit_vector_sampler
("normalized3" or "zangle"), jitter, ambient, env_flip_xz.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.rng import CounterRng, WangRng
from benchmark.reference.vec import (
    Vec3,
    cols,
    cross,
    dot3,
    fresnel_reflect_amount,
    normalize,
    reflect,
    refract,
    safe_normalize,
    where3,
)

MIN_RAY_HIT_TIME = 0.01
RAY_POS_NORMAL_NUDGE = 0.01
SUPER_FAR = 10000.0
MIN_RAY_PROBABILITY = 0.001
TWO_PI = 6.28318530718
INV_ATAN = (0.1591, 0.3183)  # the upstream's truncated (1/2pi, 1/pi)


def f32_round(x: float) -> float:
    """A Python float rounded once to float32."""
    return torch.tensor(x, dtype=torch.float32).item()


def frame_blend(frame: int) -> float:
    """1 / (f32(frame) + 1) in float32: frame 0 stores its colour."""
    one = torch.tensor(1.0, dtype=torch.float32)
    return (one / (torch.tensor(float(frame), dtype=torch.float32) + one)).item()


def tables(scene: dict, opts: dict, dtype=torch.float32, albedo=None,
           centers=None):
    """The four tables the bounce loop reads, in ``dtype``:

    quad (NQ, 25): v0, normal, n x v01, n x v12, n x v20, n x v02,
                   n x v23, n x v30 (scaled dual edges), material;
    sphere (NS, 5): center, radius, material;
    material (NM, 17): albedo, emissive, specular chance and roughness,
                       specular colour, ior, refraction chance and
                       roughness, refraction colour;
    camera (8,): position, image-plane distance, forward z, ambient.

    ``albedo`` (NM, 3) and ``centers`` (NS, 3) replace the scene's (the
    trained parameters, carried through by autograd)."""
    q = scene["quads"].to(dtype)                      # (NQ, 4, 3)
    v0, v1, v2, v3 = (cols(q[:, i]) for i in range(4))
    v01, v02, v30 = v1 - v0, v2 - v0, v0 - v3
    v20, v23, v12 = -v02, v3 - v2, v2 - v1
    v01xv02 = cross(v01, v02)
    n = normalize(v01xv02)
    inv_bot = 1.0 / dot3(v01xv02, n)
    inv_top = 1.0 / dot3(cross(v30, v01), n)
    duals = [cross(n, v01) * inv_bot, cross(n, v12) * inv_bot,
             cross(n, v20) * inv_bot, cross(n, v02) * inv_top,
             cross(n, v23) * inv_top, cross(n, v30) * inv_top]
    quad = torch.stack([c for v in (v0, n, *duals) for c in v]
                       + [scene["quad_material"].to(dtype)], -1)
    c = scene["centers"] if centers is None else centers
    sph = torch.stack([*cols(c.to(dtype)), scene["radii"].to(dtype),
                       scene["sphere_material"].to(dtype)], -1)
    m = dict(scene["materials"])
    if albedo is not None:
        m["albedo"] = albedo
    mat = torch.cat([m["albedo"], m["emissive"],
                     m["specular_chance"][:, None],
                     m["specular_roughness"][:, None], m["specular_color"],
                     m["ior"][:, None], m["refraction_chance"][:, None],
                     m["refraction_roughness"][:, None],
                     m["refraction_color"]], -1).to(dtype)
    cam = scene["camera"]
    dev = q.device
    cam_tbl = torch.tensor(
        [*cam["position"], cam["distance"], cam["forward_z"], *opts["ambient"]],
        dtype=torch.float32, device=dev).to(dtype)
    return quad, sph, mat, cam_tbl


def _unit_vector(rng, sampler: str):
    if sampler == "zangle":
        wide_z, rng = rng.next01()
        wide_a, rng = rng.next01()
        z = wide_z * 2.0 - 1.0
        a = wide_a * TWO_PI
        r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        return Vec3(r * torch.cos(a), r * torch.sin(a), z), rng
    u, rng = rng.next01()
    v, rng = rng.next01()
    w, rng = rng.next01()
    u, v, w = 2.0 * u - 1.0, 2.0 * v - 1.0, 2.0 * w - 1.0
    inv = 1.0 / torch.sqrt(torch.clamp(u * u + v * v + w * w, min=1e-20))
    return Vec3(u * inv, v * inv, w * inv), rng


def render_planes(tabs, opts: dict, frame: int, sample0: int = 0,
                  row0: int = 0, rows=None, live=None) -> torch.Tensor:
    """(12, rows, W) planes of one frame's samples for image rows
    [row0, row0 + rows): r, g, b (the sample mean of the emitted
    radiance), the first miss's direction (3) and throughput (3), the env
    jitter jr, jc, and the missed flag. Every segment runs with ended
    paths masked. ``live``, a list, receives the number of live paths at
    the start of each segment."""
    quad_tbl, sph_tbl, mat_tbl, cam_tbl = tabs
    dtype, dev = quad_tbl.dtype, quad_tbl.device
    w, height = opts["width"], opts["height"]
    h = height - row0 if rows is None else rows
    row = torch.arange(row0, row0 + h, device=dev)[:, None].expand(h, w)
    col = torch.arange(w, device=dev)[None, :].expand(h, w)
    fy_i = (height - 1) - row
    frag_x, frag_y = col.to(dtype), fy_i.to(dtype)
    zeros = torch.zeros((h, w), dtype=dtype, device=dev)
    ones = torch.ones_like(zeros)
    far = torch.full((h, w), SUPER_FAR, dtype=dtype, device=dev)

    quads = [(Vec3(*q[0:3]), Vec3(*q[3:6]), Vec3(*q[6:9]), Vec3(*q[12:15]),
              Vec3(*q[15:18]), Vec3(*q[21:24]), q[24]) for q in quad_tbl]
    inv_r = (1.0 / sph_tbl[:, 3].double()).to(dtype)
    spheres = [(Vec3(*s[0:3]), s[3], inv_r[i], s[4])
               for i, s in enumerate(sph_tbl)]
    aspect = f32_round(height / w)
    sampler = opts.get("unit_vector_sampler", "normalized3")
    roulette = opts["roulette"]

    def trace(pos, dir):
        best = far
        normal = Vec3(zeros, zeros, ones)
        inside = torch.zeros((h, w), dtype=torch.bool, device=dev)
        mat = zeros
        for v0, n, nxv01, nxv20, nxv02, nxv30, mq in quads:
            ray_off = v0 - pos
            dn = dot3(dir, n)
            tiny = torch.where(dn < 0, -1e-12, 1e-12).to(dtype)
            denom = torch.where(torch.abs(dn) < 1e-12, tiny, dn)
            dist = dot3(ray_off, n) / denom
            hitp = dir * dist - ray_off
            a0, a1 = dot3(hitp, nxv01), dot3(hitp, nxv20)
            b0, b1 = dot3(hitp, nxv30), dot3(hitp, nxv02)
            tri1 = (a0 >= 0.0) & (a1 >= 0.0) & (1.0 - a0 - a1 >= 0.0)
            tri2 = (b0 >= 0.0) & (b1 >= 0.0) & (1.0 - b0 - b1 >= 0.0)
            valid = (tri1 | tri2) & (dist > MIN_RAY_HIT_TIME) & (dist < best)
            best = torch.where(valid, dist, best)
            normal = where3(valid, where3(dn > 0.0, -n, n), normal)
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
            sgn = torch.where(from_in, -1.0, 1.0).to(dtype)
            sn = (m_ + dir * dist) * (sgn * ir)
            best = torch.where(valid, dist, best)
            normal = where3(valid, sn, normal)
            inside = (valid & from_in) | (~valid & inside)
            mat = torch.where(valid, ms, mat)
        return best, normal, inside, mat

    def bounce(s):
        rng = s["rng"]
        pos, dir, thr, ret = s["pos"], s["dir"], s["thr"], s["ret"]
        alive = s["alive"]
        dist, normal, inside, mat_idx = trace(pos, dir)
        jr, rng = rng.next01()
        jc, rng = rng.next01()
        miss = dist >= far
        first_miss = alive & miss
        update = alive & ~miss
        s["miss_dir"] = where3(first_miss, dir, s["miss_dir"])
        s["miss_thr"] = where3(first_miss, thr, s["miss_thr"])
        s["jr"] = torch.where(first_miss, jr, s["jr"])
        s["jc"] = torch.where(first_miss, jc, s["jc"])
        s["missed"] = s["missed"] | first_miss

        # an embedding lookup: its gradient sums each material's pixels by
        # a sort and segment sums (advanced indexing's backward serialises
        # the many pixels of one material)
        f = torch.nn.functional.embedding(mat_idx.to(torch.int64),
                                          mat_tbl).unbind(-1)
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
        inv_prob = 1.0 / torch.clamp(ray_prob, min=MIN_RAY_PROBABILITY).detach()

        nudge = torch.where(do_refr, -RAY_POS_NORMAL_NUDGE,
                            RAY_POS_NORMAL_NUDGE).to(dtype)
        new_pos = pos + dir * d_safe + normal * nudge

        unit_d, rng = _unit_vector(rng, sampler)
        diffuse_dir = safe_normalize(normal + unit_d)
        spec_dir = reflect(dir, normal)
        spec_dir = spec_dir + (diffuse_dir - spec_dir) * (spec_rough * spec_rough)
        unit_r, rng = _unit_vector(rng, sampler)  # drawn even where unused
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

        if roulette != "off":
            p = torch.clamp(torch.maximum(new_thr.x, torch.maximum(
                new_thr.y, new_thr.z)), 0.0, 1.0)
            rr, rng = rng.next01()
            terminated = rr > p
            boost = 1.0 / torch.clamp(p, min=MIN_RAY_PROBABILITY).detach()
            new_thr = where3(terminated, new_thr, new_thr * boost)
            if roulette == "terminate":
                update = update & ~terminated

        s.update(ret=where3(update, new_ret, ret),
                 thr=where3(update, new_thr, thr),
                 pos=where3(update, new_pos, pos),
                 dir=where3(update, new_dir, dir),
                 alive=update, rng=rng)

    def camera_ray(rng):
        if opts.get("jitter", True):
            jx, rng = rng.next01()
            jy, rng = rng.next01()
            fx, fy = frag_x + (jx - 0.5), frag_y + (jy - 0.5)
        else:
            fx, fy = frag_x, frag_y
        u = (fx / torch.full_like(fx, float(w))) * 2.0 - 1.0
        v = ((fy / torch.full_like(fy, float(height))) * 2.0 - 1.0) * aspect
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
        for _ in range(opts["bounces"] + 1):
            if live is not None:
                live.append(int(s["alive"].sum()))
            bounce(s)
        return s

    spp = opts["spp"]
    inv_spp = f32_round(1.0 / spp)
    acc = Vec3(zeros, zeros, zeros)
    if opts["rng"] == "wang":
        # one jittered ray a frame; the samples continue one stream
        rng = WangRng.from_pixel(col, fy_i, frame, dtype)
        pos, dir, rng = camera_ray(rng)
        for _ in range(spp):
            s = sample(rng, pos, dir)
            rng = s["rng"]
            acc = acc + s["ret"] * inv_spp
    else:
        for k in range(spp):
            rng = CounterRng.from_pixel(col, fy_i, frame, sample0 + k, dtype)
            pos, dir, rng = camera_ray(rng)
            s = sample(rng, pos, dir)
            acc = acc + s["ret"] * inv_spp
    md, mt = s["miss_dir"], s["miss_thr"]
    return torch.stack([acc.x, acc.y, acc.z, md.x, md.y, md.z,
                        mt.x, mt.y, mt.z, s["jr"], s["jc"],
                        s["missed"].to(dtype)])


def env_index(planes, tex_w: int, tex_h: int, opts: dict) -> torch.Tensor:
    """Flat texel index of the stochastic equirect tap of each pixel's
    first miss: uv of the (-x, y, -z) flipped direction (with
    ``env_flip_xz``), fract((atan2(z, x), asin(y)) * INV_ATAN + 0.5),
    then floor(v * (H - 1) + jr) * W + floor(u * (W - 1) + jc), the flat
    index clamped to the map (a column past the edge wraps into the next
    row, as the upstream's flat gather does)."""
    dx, dy, dz = planes[3], planes[4], planes[5]
    if opts.get("env_flip_xz", True):
        dx, dz = -dx, -dz
    u = torch.atan2(dz, dx) * INV_ATAN[0] + 0.5
    v = torch.asin(torch.clamp(dy, -1.0, 1.0)) * INV_ATAN[1] + 0.5
    u = torch.clamp(u - torch.floor(u), 0.0, 1.0)
    v = torch.clamp(v - torch.floor(v), 0.0, 1.0)
    row = torch.floor(v * float(tex_h - 1) + planes[9]).to(torch.int64)
    col = torch.floor(u * float(tex_w - 1) + planes[10]).to(torch.int64)
    return torch.clamp(row * tex_w + col, 0, tex_w * tex_h - 1)


def sample_color(planes, tex, tex_w: int, tex_h: int, opts: dict):
    """((3, h, W) colour of one sample's planes, (h, W) texel index):
    the emitted radiance plus the env texel times the miss throughput."""
    idx = env_index(planes, tex_w, tex_h, opts)
    env = tex[:, idx]                                   # (3, h, W)
    return planes[0:3] + env * planes[6:9], idx


def frame_color(tabs, tex, tex_w: int, tex_h: int, opts: dict, frame: int,
                stats=None) -> torch.Tensor:
    """(3, H, W) colour of one progressive frame. With the wang RNG, or
    one sample, the frame's planes are resolved once (the sample mean of
    the radiance plus the last sample's env term). With the counter RNG
    and several samples, each sample is rendered and looked up alone and
    the frame's colour is mean_s(rgb_s) + (sum_s env_s * thr_s) / spp.
    ``stats``, a dict, receives the live paths of each segment of each
    sample (``live``) and the distinct texels each sample read
    (``texels``)."""
    live = None if stats is None else stats.setdefault("live", [])
    texels = None if stats is None else stats.setdefault("texels", [])
    spp = opts["spp"]
    if opts["rng"] == "wang" or spp == 1:
        planes = render_planes(tabs, opts, frame, live=live)
        color, idx = sample_color(planes, tex, tex_w, tex_h, opts)
        if texels is not None:
            texels.append(int(torch.unique(idx).numel()))
        return color
    one = dict(opts, spp=1)
    inv = f32_round(1.0 / spp)
    mean = env_sum = None
    for s in range(spp):
        planes = render_planes(tabs, one, frame, sample0=s, live=live)
        idx = env_index(planes, tex_w, tex_h, opts)
        if texels is not None:
            texels.append(int(torch.unique(idx).numel()))
        term = tex[:, idx] * planes[6:9]
        rgb = planes[0:3] * inv
        mean = rgb if mean is None else mean + rgb
        env_sum = term if env_sum is None else env_sum + term
    return mean + env_sum * inv


def accumulate(accum, color, blend: float) -> torch.Tensor:
    """accum + (color - accum) * blend, in the accumulator's float32."""
    return accum + (color.to(accum.dtype) - accum) * blend


def camera_distance(fov_degrees: float) -> float:
    """The image plane's distance, 1 / tan(fov / 2), rounded to float32."""
    return f32_round(1.0 / math.tan(math.radians(fov_degrees) * 0.5))
