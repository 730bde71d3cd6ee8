// The bounce body shared by kernel A (megakernel.cu, the forward) and
// kernel C (backward.cu, its path-replay adjoint): one physics
// implementation, so the adjoint's replay takes exactly the forward's
// decisions. This is the counterpart of make_bounce_body in
// cpuperformanceraytracer_tpu/kernels/megakernel.py, which the TPU forward
// and adjoint kernels share the same way.
//
// Parity policy: built with --fmad=false and without --use_fast_math, so
// every multiply and add rounds on its own and division and sqrt are
// IEEE-exact, as in the JAX reference. Expressions keep the JAX operand
// order term by term.
//
// The functions are plain C++ apart from the qualifiers in CPRT_FN, so a
// host C++ compiler takes this header as well.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define CPRT_FN __device__ __forceinline__
#define CPRT_HD __host__ __device__ inline
#else
#include <math.h>
#define CPRT_FN inline
#define CPRT_HD inline
#endif

namespace cprt {

constexpr int QUAD_COLS = 25;
constexpr int SPH_COLS = 5;
constexpr int MAT_COLS = 17;
constexpr int CAM_COLS = 8;
constexpr float MIN_RAY_HIT_TIME = 0.01f;
constexpr float RAY_POS_NORMAL_NUDGE = 0.01f;
constexpr float SUPER_FAR = 10000.0f;
constexpr float MIN_RAY_PROBABILITY = 0.001f;
constexpr float TWO_PI = 6.28318530718f;

struct Params {
    int width, height, frame, sample0, spp, bounces;
    int nq, ns, nm;
    int counter_rng;  // 0: wang, 1: threefry counter
    int env_draws;    // 2 env-jitter draws per segment (stochastic env)
    int env_none;     // add the ambient inline at the first miss
    int roulette;     // 0 off, 1 terminate, 2 v4_quirk
    int zangle;       // unit-vector sampler: 1 zangle (2 draws), 0 normalized3
    int jitter;
    float aspect;     // height/width, rounded once from float64
    float inv_spp;
    // null, or a device int added to ``frame``: a CUDA graph replays a
    // launch with the frame the host set there (``fill_``) before the replay
    const int* frame_base;
    // the pixel-row window a launch renders: global rows [row0, row0 +
    // local_height) of the height-row image. The RNG keys and the camera
    // ray take the global row; the outputs are the window's rows.
    int row0, local_height;
};

// The frame index the RNG is keyed with.
CPRT_FN int frame_of(const Params& P) {
    return P.frame_base != nullptr ? P.frame + *P.frame_base : P.frame;
}

struct f3 {
    float x, y, z;
};

CPRT_FN f3 mk(float x, float y, float z) { return {x, y, z}; }
CPRT_FN f3 add(f3 a, f3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
CPRT_FN f3 sub(f3 a, f3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
CPRT_FN f3 mul(f3 a, f3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
CPRT_FN f3 muls(f3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
CPRT_FN f3 neg(f3 a) { return {-a.x, -a.y, -a.z}; }
CPRT_FN float dot(f3 a, f3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
CPRT_FN f3 sel(bool c, f3 a, f3 b) { return c ? a : b; }
CPRT_FN f3 load3(const float* p) { return {p[0], p[1], p[2]}; }

CPRT_FN f3 safe_normalize(f3 v) {
    float d2 = fmaxf(dot(v, v), 1e-20f);
    return muls(v, 1.0f / sqrtf(d2));
}

// ---- RNG: wang hash stream or threefry2x32 counter stream -------------

CPRT_FN uint32_t wang_hash(uint32_t s) {
    s = (s ^ 61u) ^ (s >> 16);
    s = s * 9u;
    s = s ^ (s >> 4);
    s = s * 0x27D4EB2Du;
    return s ^ (s >> 15);
}

CPRT_FN uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

CPRT_FN uint32_t threefry2x32_x0(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1) {
    const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
    const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
    uint32_t x0 = c0 + ks[0];
    uint32_t x1 = c1 + ks[1];
#pragma unroll
    for (int block = 0; block < 5; ++block) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            x0 = x0 + x1;
            x1 = rotl(x1, rot[(block % 2) * 4 + i]);
            x1 = x0 ^ x1;
        }
        x0 = x0 + ks[(block + 1) % 3];
        x1 = x1 + ks[(block + 2) % 3] + (uint32_t)(block + 1);
    }
    return x0;
}

CPRT_FN float bits_to_unit(uint32_t b) {
    return (float)(int)(b & 0x7FFFFFFFu) * (1.0f / 2147483648.0f);
}

struct Rng {
    uint32_t state;       // wang
    uint32_t key0, key1;  // counter
    uint32_t ctr;
    bool counter;

    CPRT_FN float next01() {
        if (counter) {
            return bits_to_unit(threefry2x32_x0(key0, key1, ctr++, 0u));
        }
        state = wang_hash(state);
        return bits_to_unit(state);
    }

    CPRT_FN void skip(int n) {
        if (counter) {
            ctr += (uint32_t)n;
        } else {
            for (int i = 0; i < n; ++i) state = wang_hash(state);
        }
    }
};

CPRT_FN f3 unit_vector(Rng& rng, int zangle) {
    if (zangle) {
        float wide_z = rng.next01();
        float wide_a = rng.next01();
        float z = wide_z * 2.0f - 1.0f;
        float a = wide_a * TWO_PI;
        float r = sqrtf(fmaxf(1.0f - z * z, 0.0f));
        return mk(r * cosf(a), r * sinf(a), z);
    }
    float u = rng.next01();
    float v = rng.next01();
    float w = rng.next01();
    u = 2.0f * u - 1.0f;
    v = 2.0f * v - 1.0f;
    w = 2.0f * w - 1.0f;
    float d2 = u * u + v * v + w * w;
    float inv = 1.0f / sqrtf(fmaxf(d2, 1e-20f));
    return mk(u * inv, v * inv, w * inv);
}

// Draws one live segment takes from the stream.
CPRT_FN int segment_draws(const Params& P) {
    return (P.env_draws ? 2 : 0) + 1 + 2 * (P.zangle ? 2 : 3) + (P.roulette != 0 ? 1 : 0);
}

// ---- shading math (core/vecmath.py) ------------------------------------

CPRT_FN f3 reflect(f3 v, f3 n) { return sub(v, muls(n, 2.0f * dot(v, n))); }

CPRT_FN f3 refract(f3 v, f3 n, float eta) {
    float vdotn = dot(v, n);
    float k = 1.0f - eta * eta * (1.0f - vdotn * vdotn);
    float sqrt_k = k > 0.0f ? sqrtf(k) : 0.0f;
    f3 out = sub(muls(v, eta), muls(n, eta * vdotn + sqrt_k));
    return k < 0.0f ? mk(0.0f, 0.0f, 0.0f) : out;
}

CPRT_FN float fresnel_reflect_amount(float n1, float n2, f3 normal, f3 incident, float f0,
                                     float f90) {
    float r0 = (n1 - n2) / (n1 + n2);
    r0 = r0 * r0;
    float cos_x = -dot(normal, incident);
    bool n1_gt_n2 = n1 > n2;
    float n = n1 / n2;
    float sin_t2_compl = 1.0f - (n * n) * (1.0f - cos_x * cos_x);
    bool tir = sin_t2_compl <= 0.0f;
    float new_cos_x = tir ? 0.0f : sqrtf(sin_t2_compl);
    if (n1_gt_n2 && !tir) cos_x = new_cos_x;
    float x = 1.0f - cos_x;
    float ret = r0 + (1.0f - r0) * x * x * x * x * x;
    if (n1_gt_n2 && tir) ret = 1.0f;
    return f0 + (f90 - f0) * ret;
}

// ---- scene -------------------------------------------------------------

constexpr int HIT_NONE = 0, HIT_QUAD = 1, HIT_SPHERE = 2;

struct Hit {
    float dist;
    f3 normal;
    bool inside;
    float mat;
    int kind;  // HIT_NONE, HIT_QUAD or HIT_SPHERE
    int obj;   // row of the hit object in its table
};

// Nearest hit over all quads, then all spheres (first-wins blend chain).
CPRT_FN Hit trace(const float* quads, int nq, const float* sph, const float* inv_r, int ns,
                  f3 pos, f3 dir) {
    Hit h{SUPER_FAR, mk(0.0f, 0.0f, 1.0f), false, 0.0f, HIT_NONE, 0};
    for (int qi = 0; qi < nq; ++qi) {
        const float* q = quads + qi * QUAD_COLS;
        f3 v0 = load3(q + 0), n = load3(q + 3);
        f3 ray_off = sub(v0, pos);
        float dn = dot(dir, n);
        float denom = dn;
        if (fabsf(denom) < 1e-12f) denom = denom < 0.0f ? -1e-12f : 1e-12f;
        float dist = dot(ray_off, n) / denom;
        f3 hitp = sub(muls(dir, dist), ray_off);
        float a0 = dot(hitp, load3(q + 6));
        float a1 = dot(hitp, load3(q + 12));
        float b0 = dot(hitp, load3(q + 21));
        float b1 = dot(hitp, load3(q + 15));
        bool tri1 = (a0 >= 0.0f) && (a1 >= 0.0f) && (1.0f - a0 - a1 >= 0.0f);
        bool tri2 = (b0 >= 0.0f) && (b1 >= 0.0f) && (1.0f - b0 - b1 >= 0.0f);
        if ((tri1 || tri2) && dist > MIN_RAY_HIT_TIME && dist < h.dist) {
            h.dist = dist;
            h.normal = dn > 0.0f ? neg(n) : n;
            h.mat = q[24];
            h.kind = HIT_QUAD;
            h.obj = qi;
        }
    }
    for (int si = 0; si < ns; ++si) {
        const float* s = sph + si * SPH_COLS;
        float r = s[3];
        f3 m = sub(pos, load3(s));
        float b = dot(m, dir);
        float cc = dot(m, m) - r * r;
        float discr = b * b - cc;
        bool miss = (cc > 0.0f && b > 0.0f) || discr < 0.0f;
        float sq = discr > 0.0f ? sqrtf(discr) : 0.0f;
        bool from_in = -b < sq;
        float dist = (from_in ? sq : -sq) - b;
        if (!miss && dist > MIN_RAY_HIT_TIME && dist < h.dist) {
            f3 hit_rel = add(m, muls(dir, dist));
            float sgn = from_in ? -1.0f : 1.0f;
            h.dist = dist;
            h.normal = muls(hit_rel, sgn * inv_r[si]);
            h.inside = from_in;
            h.mat = s[4];
            h.kind = HIT_SPHERE;
            h.obj = si;
        }
    }
    return h;
}

struct Path {
    f3 ret, thr, pos, dir;
    bool alive, missed;
    f3 miss_dir, miss_thr;
    float jr, jc;
};

// Everything one segment computes from its input state: kernel A keeps
// the new state, kernel C also reads the intermediates its adjoint needs.
struct Seg {
    Hit hit;
    bool miss;
    float jr, jc;
    const float* m;  // the hit material's row
    f3 thr1;         // throughput after Beer absorption
    bool do_spec, do_refr, terminated;
    float inv_prob;  // detached estimator weights
    float boost;
    f3 unit_d, unit_r;
    f3 diffuse_dir, spec_refl, spec_dir, refr_raw, refr_target, refr_dir, dir_raw;
    f3 new_ret, new_thr, new_pos, new_dir;
    bool update;
};

// One bounce segment of make_bounce_body (megakernel.py:496-667) at the
// state ``p`` (``p.alive`` true): the hit, the miss flag, the shading and
// the state the segment would move to, into ``s``.
CPRT_FN void segment(const Path& p, Rng& rng, const Params& P, const float* quads,
                     const float* sph, const float* inv_r, const float* mats, const float* cam,
                     Seg& s) {
    s.hit = trace(quads, P.nq, sph, inv_r, P.ns, p.pos, p.dir);
    s.jr = 0.0f;
    s.jc = 0.0f;
    if (P.env_draws) {
        s.jr = rng.next01();
        s.jc = rng.next01();
    }
    s.miss = s.hit.dist >= SUPER_FAR;
    f3 ret = p.ret;
    if (s.miss && P.env_none) {
        ret = mk(p.ret.x + cam[5] * p.thr.x, p.ret.y + cam[6] * p.thr.y,
                 p.ret.z + cam[7] * p.thr.z);
    }

    // every material index is an exact small integer: a direct row fetch
    // equals the TPU kernel's select chain
    const float* m = mats + (int)s.hit.mat * MAT_COLS;
    s.m = m;
    f3 albedo = load3(m + 0), emissive = load3(m + 3);
    float spec_ch = m[6], spec_rough = m[7];
    f3 spec_color = load3(m + 8);
    float ior = m[11], refr_ch = m[12], refr_rough = m[13];
    f3 refr_color = load3(m + 14);
    bool inside = s.hit.inside;
    f3 normal = s.hit.normal;

    float d_safe = s.miss ? 0.0f : s.hit.dist;
    f3 new_thr = p.thr;
    if (inside) {
        new_thr = mk(p.thr.x * expf(-refr_color.x * d_safe),
                     p.thr.y * expf(-refr_color.y * d_safe),
                     p.thr.z * expf(-refr_color.z * d_safe));
    }
    s.thr1 = new_thr;

    bool has_spec = spec_ch > 0.0f;
    float n1 = inside ? ior : 1.0f;
    float n2 = inside ? 1.0f : ior;
    float fres = fresnel_reflect_amount(n1, n2, normal, p.dir, spec_ch, 1.0f);
    float chance_mult = (1.0f - fres) / fmaxf(1.0f - spec_ch, 1e-6f);
    float spec_chance = has_spec ? fres : spec_ch;
    float refr_chance = has_spec ? refr_ch * chance_mult : refr_ch;

    float roll = rng.next01();
    s.do_spec = spec_chance > 0.0f && roll < spec_chance;
    s.do_refr = !s.do_spec && refr_chance > 0.0f && roll < spec_chance + refr_chance;
    float diff_chance = fmaxf(1.0f - (spec_chance + refr_chance), 0.0f);
    float ray_prob = s.do_spec ? spec_chance : (s.do_refr ? refr_chance : diff_chance);
    s.inv_prob = 1.0f / fmaxf(ray_prob, MIN_RAY_PROBABILITY);

    float nudge = s.do_refr ? -RAY_POS_NORMAL_NUDGE : RAY_POS_NORMAL_NUDGE;
    s.new_pos = add(add(p.pos, muls(p.dir, d_safe)), muls(normal, nudge));

    s.unit_d = unit_vector(rng, P.zangle);
    s.diffuse_dir = safe_normalize(add(normal, s.unit_d));
    s.spec_refl = reflect(p.dir, normal);
    s.spec_dir = add(s.spec_refl,
                     muls(sub(s.diffuse_dir, s.spec_refl), spec_rough * spec_rough));
    // the refraction unit vector is drawn even where it is unused (stream contract)
    s.unit_r = unit_vector(rng, P.zangle);
    float eta = inside ? ior : 1.0f / ior;
    s.refr_raw = refract(p.dir, normal, eta);
    s.refr_target = safe_normalize(sub(s.unit_r, normal));
    s.refr_dir = add(s.refr_raw, muls(sub(s.refr_target, s.refr_raw), refr_rough * refr_rough));
    s.dir_raw = sel(s.do_spec, s.spec_dir, sel(s.do_refr, s.refr_dir, s.diffuse_dir));
    s.new_dir = safe_normalize(s.dir_raw);

    s.new_ret = add(ret, mul(emissive, new_thr));
    f3 color_factor = s.do_spec ? spec_color : albedo;
    if (!s.do_refr) new_thr = mul(new_thr, color_factor);
    new_thr = muls(new_thr, s.inv_prob);

    s.update = !s.miss;
    s.terminated = false;
    s.boost = 1.0f;
    if (P.roulette != 0) {
        float pr = fminf(fmaxf(fmaxf(new_thr.x, fmaxf(new_thr.y, new_thr.z)), 0.0f), 1.0f);
        float rr = rng.next01();
        s.terminated = rr > pr;
        s.boost = 1.0f / fmaxf(pr, MIN_RAY_PROBABILITY);
        if (!s.terminated) new_thr = muls(new_thr, s.boost);
        if (P.roulette == 1 && s.terminated) s.update = false;
    }
    s.new_thr = new_thr;
    if (s.miss) s.new_ret = ret;  // a miss keeps the (ambient-lit) return
}

// Move the path to the state segment ``s`` computed at it (bounce's
// update; kernel C's replay keeps only thr, pos and dir of it).
CPRT_FN void advance(Path& p, const Seg& s) {
    if (s.miss) {
        p.ret = s.new_ret;
        p.miss_dir = p.dir;
        p.miss_thr = p.thr;
        p.jr = s.jr;
        p.jc = s.jc;
        p.missed = true;
    }
    if (s.update) {
        p.ret = s.new_ret;
        p.thr = s.new_thr;
        p.pos = s.new_pos;
        p.dir = s.new_dir;
    }
    p.alive = s.update;
}

// Advance the path by one segment (kernel A's bounce).
CPRT_FN void bounce(Path& p, Rng& rng, const Params& P, const float* quads, const float* sph,
                    const float* inv_r, const float* mats, const float* cam) {
    Seg s;
    segment(p, rng, P, quads, sph, inv_r, mats, cam, s);
    advance(p, s);
}

// The jittered primary ray (camera_ray_blk). ``target`` is the direction
// before normalisation.
CPRT_FN void camera_ray(Rng& rng, const Params& P, const float* cam, float frag_x,
                        float frag_y, f3& pos, f3& dir, f3& target) {
    float fx = frag_x, fy = frag_y;
    if (P.jitter) {
        float jx = rng.next01();
        float jy = rng.next01();
        fx = frag_x + (jx - 0.5f);
        fy = frag_y + (jy - 0.5f);
    }
    float u = (fx / (float)P.width) * 2.0f - 1.0f;
    float v = (fy / (float)P.height) * 2.0f - 1.0f;
    v = v * P.aspect;
    pos = load3(cam);
    target = mk(u, v, cam[4] * cam[3]);
    dir = safe_normalize(target);
}

// The scene tables in shared memory: quads, spheres, 1/r, materials, camera.
struct SceneSmem {
    float *quads, *sph, *inv_r, *mats, *cam;
};

CPRT_HD int scene_smem_floats(int nq, int ns, int nm) {
    return nq * QUAD_COLS + ns * SPH_COLS + ns + nm * MAT_COLS + CAM_COLS;
}

#ifdef __CUDACC__
// Copy the tables into ``smem`` (all threads of the block take part; the
// caller synchronises). 1/r is rounded from float64, as the JAX main
// path's baked constant.
__device__ __forceinline__ SceneSmem load_scene(const Params& P, const float* quad_tbl,
                                                const float* sph_tbl, const float* mat_tbl,
                                                const float* cam_tbl, float* smem) {
    SceneSmem S;
    S.quads = smem;
    S.sph = S.quads + P.nq * QUAD_COLS;
    S.inv_r = S.sph + P.ns * SPH_COLS;
    S.mats = S.inv_r + P.ns;
    S.cam = S.mats + P.nm * MAT_COLS;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nthreads = blockDim.x * blockDim.y;
    for (int i = tid; i < P.nq * QUAD_COLS; i += nthreads) S.quads[i] = quad_tbl[i];
    for (int i = tid; i < P.ns * SPH_COLS; i += nthreads) S.sph[i] = sph_tbl[i];
    for (int i = tid; i < P.nm * MAT_COLS; i += nthreads) S.mats[i] = mat_tbl[i];
    for (int i = tid; i < CAM_COLS; i += nthreads) S.cam[i] = cam_tbl[i];
    for (int i = tid; i < P.ns; i += nthreads)
        S.inv_r[i] = (float)(1.0 / (double)sph_tbl[i * SPH_COLS + 3]);
    return S;
}
#endif

// Counter-stream keys of pixel (col, fy_i) for one (frame, sample).
CPRT_FN void counter_keys(Rng& rng, int col, int fy_i, int frame, int sample) {
    rng.counter = true;
    rng.state = 0u;
    rng.ctr = 0u;
    rng.key0 = (uint32_t)col * 1973u + (uint32_t)fy_i * 9277u;
    rng.key1 = (uint32_t)frame * 26699u + (uint32_t)sample * 40503u + 1u;
}

}  // namespace cprt
