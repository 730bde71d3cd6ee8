// Kernel C: the path-replay adjoint of kernel A (sm_90a).
//
// Replaces cpuperformanceraytracer_tpu/kernels/backward.py::_make_bwd_call
// (the Pallas adjoint kernel behind _bwd_tables). Given the cotangents of
// kernel A's rgb and miss-throughput planes (cot6: d r, d g, d b, d mt_x,
// d mt_y, d mt_z, each (H, W)), it computes the cotangent of every cell of
// the four scene tables for one counter-RNG sample (spp = 1 per dispatch),
// with the gradient policy of diff/grad.py: the lottery and roulette
// weights are detached, and every decision is replayed from the forward.
//
// Shape: one thread per pixel, on kernel A's grid.
//   1. Replay the camera ray and the live segments with kernel A's own
//      bounce body (bounce.cuh), storing each segment's input throughput,
//      position and direction in per-thread local memory. The replay stops
//      where the path dies: a dead segment is an identity, so its adjoint
//      is too (the TPU kernel copies dead segments, backward.py:404-426).
//   2. Walk the live segments in reverse: recompute the segment's
//      intermediates at its stored state (the same function again) and
//      apply the hand-derived adjoint of the bounce body (CUDA has no
//      jax.vjp): hit geometry, Beer absorption, reflect, refract, the
//      roughness lerps, safe_normalize, emissive and colour factor.
//   3. Apply the camera adjoint.
// Table cotangents go into a shared-memory copy of all cells with shared
// atomics; each block writes its row of an (n_blocks, n_cells) partials
// tensor, summed by the wrapper (the counterpart of the XLA sum outside
// the TPU kernel, backward.py:544). The summation order therefore differs
// from autograd's and varies from run to run.
//
// What bounds it on the card: FP32 issue, as kernel A, about three times
// its work per live segment (replay, recompute, adjoint), plus shared
// atomics that serialise where a warp's paths hit the same object. This
// first version is the simple, exact one.
//
// Built like kernel A: --fmad=false, no fast math. The per-pixel adjoint
// is plain C++ apart from its qualifiers, like bounce.cuh; the kernel and its
// launcher are CUDA only.

#include "bounce.cuh"

namespace {

using namespace cprt;

constexpr int MAX_SEGMENTS = 32;

// Offsets of the four tables in the flat cotangent row.
struct Cells {
    int quad, sph, mat, cam, n;
};

CPRT_HD Cells cell_layout(int nq, int ns, int nm) {
    Cells c;
    c.quad = 0;
    c.sph = nq * QUAD_COLS;
    c.mat = c.sph + ns * SPH_COLS;
    c.cam = c.mat + nm * MAT_COLS;
    c.n = c.cam + CAM_COLS;
    return c;
}

// Cotangent of v given the cotangent g of safe_normalize(v); zero
// gradient through the length where the 1e-20 floor is taken.
CPRT_FN f3 safe_normalize_adj(f3 v, f3 g) {
    float d2 = dot(v, v);
    float s = 1.0f / sqrtf(fmaxf(d2, 1e-20f));
    f3 gv = muls(g, s);
    if (d2 >= 1e-20f) {
        float g_d2 = dot(g, v) * (-0.5f * s * s * s);
        gv = add(gv, muls(v, 2.0f * g_d2));
    }
    return gv;
}

// Cotangents of the path state between two segments.
struct Adj {
    f3 ret, thr, pos, dir;
    f3 miss_thr;  // of the miss-throughput output, taken at the first miss
};

template <class Acc>
CPRT_FN void acc3(Acc& acc, int cell, f3 v) {
    acc(cell, v.x);
    acc(cell + 1, v.y);
    acc(cell + 2, v.z);
}

// Reverse one live segment: ``p`` is its input state, ``s`` what it
// computed there; ``a`` holds the cotangents of its outputs on entry and
// of its inputs on return.
template <class Acc>
CPRT_FN void segment_adjoint(const Path& p, const Seg& s, const Params& P, const float* quads,
                             const float* sph, const float* inv_r, const float* cam,
                             const Cells& C, Adj& a, Acc& acc) {
    if (s.miss) {
        // first miss: miss_thr = thr, and with env none ret += ambient * thr
        if (P.env_none) {
            acc3(acc, C.cam + 5, mul(a.ret, p.thr));
            a.thr = add(a.thr, mul(a.ret, load3(cam + 5)));
        }
        a.thr = add(a.thr, a.miss_thr);
        return;
    }
    if (!s.update) return;  // terminated by roulette "terminate": an identity

    const float* m = s.m;
    const int mrow = C.mat + (int)s.hit.mat * MAT_COLS;
    const float dist = s.hit.dist;
    const f3 normal = s.hit.normal;
    const bool inside = s.hit.inside;

    // thr_out = thr1 [* colour factor] * inv_prob [* boost]; the weights
    // are constants of the adjoint
    f3 gt = a.thr;
    if (P.roulette != 0 && !s.terminated) gt = muls(gt, s.boost);
    gt = muls(gt, s.inv_prob);
    f3 g_thr1 = gt;
    if (!s.do_refr) {
        g_thr1 = mul(gt, s.do_spec ? load3(m + 8) : load3(m + 0));
        acc3(acc, mrow + (s.do_spec ? 8 : 0), mul(gt, s.thr1));
    }
    // ret_out = ret + emissive * thr1 (ret passes through)
    acc3(acc, mrow + 3, mul(a.ret, s.thr1));
    g_thr1 = add(g_thr1, mul(a.ret, load3(m + 3)));

    float g_dist = 0.0f;
    f3 g_normal = mk(0.0f, 0.0f, 0.0f);
    f3 g_dir = mk(0.0f, 0.0f, 0.0f);
    f3 g_thr = g_thr1;

    // Beer absorption: thr1 = thr * exp(-refr_color * dist) inside
    if (inside) {
        const float thr_in[3] = {p.thr.x, p.thr.y, p.thr.z};
        const float g1[3] = {g_thr1.x, g_thr1.y, g_thr1.z};
        float g_out[3];
        for (int c = 0; c < 3; ++c) {
            float rc = m[14 + c];
            float e = expf(-rc * dist);
            g_out[c] = g1[c] * e;
            float g_x = (g1[c] * thr_in[c]) * e;
            acc(mrow + 14 + c, -(g_x * dist));
            g_dist += g_x * (-rc);
        }
        g_thr = mk(g_out[0], g_out[1], g_out[2]);
    }

    // pos_out = (pos + dir * dist) + normal * nudge
    const float nudge = s.do_refr ? -RAY_POS_NORMAL_NUDGE : RAY_POS_NORMAL_NUDGE;
    f3 g_pos = a.pos;
    g_dir = add(g_dir, muls(a.pos, dist));
    g_dist += dot(a.pos, p.dir);
    g_normal = add(g_normal, muls(a.pos, nudge));

    // dir_out = safe_normalize(the chosen direction)
    const f3 g_raw = safe_normalize_adj(s.dir_raw, a.dir);
    f3 g_diffuse = mk(0.0f, 0.0f, 0.0f);
    if (s.do_spec) {
        // spec = refl + (diffuse - refl) * rough^2, refl = reflect(dir, n)
        const float rough = m[7];
        const float k = rough * rough;
        const f3 g_refl = sub(g_raw, muls(g_raw, k));
        g_diffuse = muls(g_raw, k);
        acc(mrow + 7, dot(g_raw, sub(s.diffuse_dir, s.spec_refl)) * 2.0f * rough);
        const float t = 2.0f * dot(p.dir, normal);
        g_dir = add(g_dir, g_refl);
        g_normal = sub(g_normal, muls(g_refl, t));
        const float g_dvn = -2.0f * dot(g_refl, normal);
        g_dir = add(g_dir, muls(normal, g_dvn));
        g_normal = add(g_normal, muls(p.dir, g_dvn));
    } else if (s.do_refr) {
        // refr = raw + (target - raw) * rough^2, target = safe_normalize(unit_r - n)
        const float rough = m[13];
        const float k = rough * rough;
        const f3 g_rr = sub(g_raw, muls(g_raw, k));
        acc(mrow + 13, dot(g_raw, sub(s.refr_target, s.refr_raw)) * 2.0f * rough);
        g_normal = sub(g_normal, safe_normalize_adj(sub(s.unit_r, normal), muls(g_raw, k)));
        // raw = refract(dir, n, eta): zero on total internal reflection
        const float ior = m[11];
        const float eta = inside ? ior : 1.0f / ior;
        const float vdotn = dot(p.dir, normal);
        const float w = 1.0f - vdotn * vdotn;
        const float kk = 1.0f - eta * eta * w;
        if (!(kk < 0.0f)) {
            const float sqrt_k = kk > 0.0f ? sqrtf(kk) : 0.0f;
            const float aa = eta * vdotn + sqrt_k;
            g_dir = add(g_dir, muls(g_rr, eta));
            float g_eta = dot(g_rr, p.dir);
            g_normal = sub(g_normal, muls(g_rr, aa));
            const float g_a = -dot(g_rr, normal);
            g_eta += g_a * vdotn;
            float g_vdotn = g_a * eta;
            const float g_k = kk > 0.0f ? g_a * 0.5f / sqrt_k : 0.0f;
            g_eta += (-g_k * w) * 2.0f * eta;
            g_vdotn += -2.0f * vdotn * (-g_k * (eta * eta));
            g_dir = add(g_dir, muls(normal, g_vdotn));
            g_normal = add(g_normal, muls(p.dir, g_vdotn));
            acc(mrow + 11, inside ? g_eta : -g_eta / (ior * ior));
        }
    } else {
        g_diffuse = g_raw;
    }
    // diffuse = safe_normalize(n + unit_d)
    g_normal = add(g_normal, safe_normalize_adj(add(normal, s.unit_d), g_diffuse));

    // hit geometry: (dist, normal) as functions of pos, dir and the object
    const int obj = s.hit.obj;
    if (s.hit.kind == HIT_QUAD) {
        // dist = dot(v0 - pos, n) / denom, denom = dot(dir, n) floored at
        // +-1e-12; normal = -n where dot(dir, n) > 0. The edge vectors only
        // enter comparisons.
        const float* q = quads + obj * QUAD_COLS;
        const f3 v0 = load3(q), n = load3(q + 3);
        const f3 ray_off = sub(v0, p.pos);
        const float dn = dot(p.dir, n);
        const bool floored = fabsf(dn) < 1e-12f;
        const float denom = floored ? (dn < 0.0f ? -1e-12f : 1e-12f) : dn;
        const float num = dot(ray_off, n);
        f3 g_n = dn > 0.0f ? neg(g_normal) : g_normal;
        const float g_num = g_dist / denom;
        const float g_den = -g_dist * num / (denom * denom);
        g_n = add(g_n, muls(ray_off, g_num));
        const f3 g_off = muls(n, g_num);
        g_pos = sub(g_pos, g_off);
        if (!floored) {
            g_dir = add(g_dir, muls(n, g_den));
            g_n = add(g_n, muls(p.dir, g_den));
        }
        acc3(acc, C.quad + obj * QUAD_COLS, g_off);
        acc3(acc, C.quad + obj * QUAD_COLS + 3, g_n);
    } else {
        // m = pos - c; b = dot(m, dir); cc = dot(m, m) - r^2;
        // discr = b^2 - cc; dist = (+-sqrt(discr)) - b;
        // normal = (m + dir * dist) * (sgn / r)
        const float* sp = sph + obj * SPH_COLS;
        const float r = sp[3], ir = inv_r[obj];
        const f3 mm = sub(p.pos, load3(sp));
        const float b = dot(mm, p.dir);
        const float cc = dot(mm, mm) - r * r;
        const float discr = b * b - cc;
        const float sq = discr > 0.0f ? sqrtf(discr) : 0.0f;
        const bool from_in = -b < sq;
        const f3 hit_rel = add(mm, muls(p.dir, dist));
        const float sgn = from_in ? -1.0f : 1.0f;
        const f3 g_hit = muls(g_normal, sgn * ir);
        float g_r = (sgn * dot(g_normal, hit_rel)) * -(ir * ir);
        f3 g_m = g_hit;
        g_dir = add(g_dir, muls(g_hit, dist));
        const float g_d = g_dist + dot(g_hit, p.dir);
        float g_b = -g_d;
        const float g_discr = discr > 0.0f ? (from_in ? g_d : -g_d) * 0.5f / sq : 0.0f;
        g_b += 2.0f * b * g_discr;
        const float g_cc = -g_discr;
        g_m = add(g_m, muls(mm, 2.0f * g_cc));
        g_r += -2.0f * r * g_cc;
        g_m = add(g_m, muls(p.dir, g_b));
        g_dir = add(g_dir, muls(mm, g_b));
        g_pos = add(g_pos, g_m);
        acc3(acc, C.sph + obj * SPH_COLS, neg(g_m));
        acc(C.sph + obj * SPH_COLS + 3, g_r);
    }
    a.thr = g_thr;
    a.pos = g_pos;
    a.dir = g_dir;
}

// The table cotangents of one pixel: ``cot`` holds its six output
// cotangents (d r, d g, d b, d mt xyz). Returns the live segment count.
template <class Acc>
CPRT_FN int pixel_adjoint(const Params& P, const float* quads, const float* sph,
                          const float* inv_r, const float* mats, const float* cam,
                          const Cells& C, int col, int row, const float* cot, Acc& acc) {
    const int fy_i = (P.height - 1) - row;
    Rng rng;
    counter_keys(rng, col, fy_i, P.frame, P.sample0);
    f3 pos0, dir0, target;
    camera_ray(rng, P, cam, (float)col, (float)fy_i, pos0, dir0, target);
    const uint32_t ctr0 = rng.ctr;
    const int n_draws = segment_draws(P);

    // forward replay: the input state of every live segment
    f3 st_thr[MAX_SEGMENTS], st_pos[MAX_SEGMENTS], st_dir[MAX_SEGMENTS];
    Path p;
    p.ret = mk(0.0f, 0.0f, 0.0f);
    p.thr = mk(1.0f, 1.0f, 1.0f);
    p.pos = pos0;
    p.dir = dir0;
    p.alive = true;
    p.missed = false;
    p.miss_dir = mk(0.0f, 0.0f, 1.0f);
    p.miss_thr = mk(0.0f, 0.0f, 0.0f);
    p.jr = 0.0f;
    p.jc = 0.0f;
    int n_live = 0;
    for (int seg = 0; seg <= P.bounces && p.alive; ++seg) {
        st_thr[seg] = p.thr;
        st_pos[seg] = p.pos;
        st_dir[seg] = p.dir;
        bounce(p, rng, P, quads, sph, inv_r, mats, cam);
        ++n_live;
    }

    // reverse sweep (spp = 1: the ret cotangent is the rgb cotangent)
    Adj a;
    a.ret = mk(cot[0], cot[1], cot[2]);
    a.thr = a.pos = a.dir = mk(0.0f, 0.0f, 0.0f);
    a.miss_thr = mk(cot[3], cot[4], cot[5]);
    for (int seg = n_live - 1; seg >= 0; --seg) {
        Path q = p;
        q.ret = mk(0.0f, 0.0f, 0.0f);  // only the discarded new_ret reads it
        q.thr = st_thr[seg];
        q.pos = st_pos[seg];
        q.dir = st_dir[seg];
        q.alive = true;
        rng.ctr = ctr0 + (uint32_t)(seg * n_draws);
        Seg s;
        segment(q, rng, P, quads, sph, inv_r, mats, cam, s);
        segment_adjoint(q, s, P, quads, sph, inv_r, cam, C, a, acc);
    }

    // camera: pos = cam[0:3]; dir = safe_normalize(u, v, cam[4] * cam[3])
    acc3(acc, C.cam, a.pos);
    const f3 g_t = safe_normalize_adj(target, a.dir);
    acc(C.cam + 3, g_t.z * cam[4]);
    acc(C.cam + 4, g_t.z * cam[3]);
    return n_live;
}

#ifdef __CUDACC__

struct SharedAcc {
    float* cells;
    __device__ __forceinline__ void operator()(int cell, float v) {
        if (v != 0.0f) atomicAdd(&cells[cell], v);
    }
};

__global__ void __launch_bounds__(128)
bwd_tables_kernel(Params P, const float* __restrict__ quad_tbl,
                  const float* __restrict__ sph_tbl, const float* __restrict__ mat_tbl,
                  const float* __restrict__ cam_tbl, const float* __restrict__ cot6,
                  float* __restrict__ partials) {
    extern __shared__ float smem[];
    const SceneSmem S = load_scene(P, quad_tbl, sph_tbl, mat_tbl, cam_tbl, smem);
    const Cells C = cell_layout(P.nq, P.ns, P.nm);
    float* cells = smem + scene_smem_floats(P.nq, P.ns, P.nm);
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nthreads = blockDim.x * blockDim.y;
    for (int i = tid; i < C.n; i += nthreads) cells[i] = 0.0f;
    __syncthreads();

    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = blockIdx.y * blockDim.y + threadIdx.y;
    if (col < P.width && row < P.height) {
        const size_t n = (size_t)P.width * P.height;
        const size_t i = (size_t)row * P.width + col;
        float cot[6];
        for (int k = 0; k < 6; ++k) cot[k] = cot6[k * n + i];
        SharedAcc acc{cells};
        pixel_adjoint(P, S.quads, S.sph, S.inv_r, S.mats, S.cam, C, col, row, cot, acc);
    }
    __syncthreads();
    float* out = partials + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * C.n;
    for (int i = tid; i < C.n; i += nthreads) out[i] = cells[i];
}

#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__

// Launch on ``stream``; ``partials`` is (n_blocks, n_cells) f32 with
// n_blocks = ceil(W/32) * ceil(H/4), n_cells = NQ*25 + NS*5 + NM*17 + 8.
extern "C" int cprt_bwd_tables(const float* quad_tbl, int nq, const float* sph_tbl, int ns,
                               const float* mat_tbl, int nm, const float* cam_tbl,
                               const float* cot6, float* partials, int width, int height,
                               int frame, int sample0, int bounces, int env_draws,
                               int env_none, int roulette, int zangle, int jitter,
                               float aspect, void* stream) {
    if (bounces + 1 > MAX_SEGMENTS) return (int)cudaErrorInvalidValue;
    Params P{width, height, frame, sample0, 1, bounces, nq, ns, nm,
             1, env_draws, env_none, roulette, zangle, jitter,
             aspect, 1.0f};
    const Cells C = cell_layout(nq, ns, nm);
    const size_t smem = (size_t)(scene_smem_floats(nq, ns, nm) + C.n) * sizeof(float);
    const dim3 block(32, 4);
    const dim3 grid((width + 31) / 32, (height + 3) / 4);
    bwd_tables_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
        P, quad_tbl, sph_tbl, mat_tbl, cam_tbl, cot6, partials);
    return (int)cudaGetLastError();
}

#endif  // __CUDACC__
