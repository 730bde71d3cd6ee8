// Kernel A: forward path-tracing megakernel for Hopper (sm_90a).
//
// Replaces cpuperformanceraytracer_tpu/kernels/megakernel.py::_make_kernel
// (the Pallas kernel dispatched by _pallas_render). It computes the same
// 12 (H, W) f32 planes: r, g, b, miss_dir xyz, miss_thr xyz, jr, jc,
// missed. The env lookup stays deferred to kernel B (env_accumulate.cu).
//
// Shape: one thread per pixel, looping over samples and bounce segments;
// 32x4-thread blocks, so a warp is 32 neighbouring pixels of one row.
// The scene tables (~330 floats for glass_spheres) are copied into shared
// memory at block start. The TPU kernel's block-level early exit becomes
// a per-thread exit, legal exactly where the TPU kernel allows one: every
// sample of the counter RNG and the last sample of the wang RNG. A dead
// segment that may not exit still consumes its draws.
//
// What bounds it on the card: FP32 issue and warp divergence from the
// material lottery, not memory traffic (12 plane stores per pixel against
// some thousands of flops). This first version is the simple, exact one;
// warp-level reorganisation of paths is later work.
//
// Parity policy: built with --fmad=false and without --use_fast_math, so
// every multiply and add rounds on its own and division and sqrt are
// IEEE-exact, as in the JAX reference. Expressions keep the JAX operand
// order term by term.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
    int early_exit;
    float aspect;     // height/width, rounded once from float64
    float inv_spp;
};

struct f3 {
    float x, y, z;
};

__device__ __forceinline__ f3 mk(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ f3 add(f3 a, f3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ f3 sub(f3 a, f3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ f3 mul(f3 a, f3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ f3 muls(f3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ f3 neg(f3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(f3 a, f3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ f3 sel(bool c, f3 a, f3 b) { return c ? a : b; }
__device__ __forceinline__ f3 load3(const float* p) { return {p[0], p[1], p[2]}; }

__device__ __forceinline__ f3 safe_normalize(f3 v) {
    float d2 = fmaxf(dot(v, v), 1e-20f);
    return muls(v, 1.0f / sqrtf(d2));
}

// ---- RNG: wang hash stream or threefry2x32 counter stream -------------

__device__ __forceinline__ uint32_t wang_hash(uint32_t s) {
    s = (s ^ 61u) ^ (s >> 16);
    s = s * 9u;
    s = s ^ (s >> 4);
    s = s * 0x27D4EB2Du;
    return s ^ (s >> 15);
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t threefry2x32_x0(uint32_t k0, uint32_t k1,
                                                    uint32_t c0, uint32_t c1) {
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

__device__ __forceinline__ float bits_to_unit(uint32_t b) {
    return (float)(int)(b & 0x7FFFFFFFu) * (1.0f / 2147483648.0f);
}

struct Rng {
    uint32_t state;      // wang
    uint32_t key0, key1; // counter
    uint32_t ctr;
    bool counter;

    __device__ __forceinline__ float next01() {
        if (counter) {
            return bits_to_unit(threefry2x32_x0(key0, key1, ctr++, 0u));
        }
        state = wang_hash(state);
        return bits_to_unit(state);
    }

    __device__ __forceinline__ void skip(int n) {
        if (counter) {
            ctr += (uint32_t)n;
        } else {
            for (int i = 0; i < n; ++i) state = wang_hash(state);
        }
    }
};

__device__ __forceinline__ f3 unit_vector(Rng& rng, int zangle) {
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

// ---- shading math (core/vecmath.py) ------------------------------------

__device__ __forceinline__ f3 reflect(f3 v, f3 n) {
    return sub(v, muls(n, 2.0f * dot(v, n)));
}

__device__ __forceinline__ f3 refract(f3 v, f3 n, float eta) {
    float vdotn = dot(v, n);
    float k = 1.0f - eta * eta * (1.0f - vdotn * vdotn);
    float sqrt_k = k > 0.0f ? sqrtf(k) : 0.0f;
    f3 out = sub(muls(v, eta), muls(n, eta * vdotn + sqrt_k));
    return k < 0.0f ? mk(0.0f, 0.0f, 0.0f) : out;
}

__device__ __forceinline__ float fresnel_reflect_amount(float n1, float n2, f3 normal,
                                                        f3 incident, float f0, float f90) {
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

struct Hit {
    float dist;
    f3 normal;
    bool inside;
    float mat;
};

// Nearest hit over all quads, then all spheres (first-wins blend chain).
__device__ __forceinline__ Hit trace(const float* quads, int nq, const float* sph,
                                     const float* inv_r, int ns, f3 pos, f3 dir) {
    Hit h{SUPER_FAR, mk(0.0f, 0.0f, 1.0f), false, 0.0f};
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

// One bounce segment of make_bounce_body (megakernel.py:496-667).
__device__ __forceinline__ void bounce(Path& p, Rng& rng, const Params& P, const float* quads,
                                       const float* sph, const float* inv_r,
                                       const float* mats, const float* cam) {
    Hit hit = trace(quads, P.nq, sph, inv_r, P.ns, p.pos, p.dir);
    float jr = 0.0f, jc = 0.0f;
    if (P.env_draws) {
        jr = rng.next01();
        jc = rng.next01();
    }
    bool miss = hit.dist >= SUPER_FAR;
    bool first_miss = p.alive && miss;
    bool update = p.alive && !miss;
    if (first_miss) {
        if (P.env_none) {
            p.ret = mk(p.ret.x + cam[5] * p.thr.x, p.ret.y + cam[6] * p.thr.y,
                       p.ret.z + cam[7] * p.thr.z);
        }
        p.miss_dir = p.dir;
        p.miss_thr = p.thr;
        p.jr = jr;
        p.jc = jc;
        p.missed = true;
    }

    // every material index is an exact small integer: a direct row fetch
    // equals the TPU kernel's select chain
    const float* m = mats + (int)hit.mat * MAT_COLS;
    f3 albedo = load3(m + 0), emissive = load3(m + 3);
    float spec_ch = m[6], spec_rough = m[7];
    f3 spec_color = load3(m + 8);
    float ior = m[11], refr_ch = m[12], refr_rough = m[13];
    f3 refr_color = load3(m + 14);
    bool inside = hit.inside;
    f3 normal = hit.normal;

    float d_safe = miss ? 0.0f : hit.dist;
    f3 new_thr = p.thr;
    if (inside) {
        new_thr = mk(p.thr.x * expf(-refr_color.x * d_safe),
                     p.thr.y * expf(-refr_color.y * d_safe),
                     p.thr.z * expf(-refr_color.z * d_safe));
    }

    bool has_spec = spec_ch > 0.0f;
    float n1 = inside ? ior : 1.0f;
    float n2 = inside ? 1.0f : ior;
    float fres = fresnel_reflect_amount(n1, n2, normal, p.dir, spec_ch, 1.0f);
    float chance_mult = (1.0f - fres) / fmaxf(1.0f - spec_ch, 1e-6f);
    float spec_chance = has_spec ? fres : spec_ch;
    float refr_chance = has_spec ? refr_ch * chance_mult : refr_ch;

    float roll = rng.next01();
    bool do_spec = spec_chance > 0.0f && roll < spec_chance;
    bool do_refr = !do_spec && refr_chance > 0.0f && roll < spec_chance + refr_chance;
    float diff_chance = fmaxf(1.0f - (spec_chance + refr_chance), 0.0f);
    float ray_prob = do_spec ? spec_chance : (do_refr ? refr_chance : diff_chance);
    float inv_prob = 1.0f / fmaxf(ray_prob, MIN_RAY_PROBABILITY);

    float nudge = do_refr ? -RAY_POS_NORMAL_NUDGE : RAY_POS_NORMAL_NUDGE;
    f3 new_pos = add(add(p.pos, muls(p.dir, d_safe)), muls(normal, nudge));

    f3 unit_d = unit_vector(rng, P.zangle);
    f3 diffuse_dir = safe_normalize(add(normal, unit_d));
    f3 spec_dir = reflect(p.dir, normal);
    spec_dir = add(spec_dir, muls(sub(diffuse_dir, spec_dir), spec_rough * spec_rough));
    // the refraction unit vector is drawn even where it is unused (stream contract)
    f3 unit_r = unit_vector(rng, P.zangle);
    float eta = inside ? ior : 1.0f / ior;
    f3 refr_dir = refract(p.dir, normal, eta);
    f3 refr_target = safe_normalize(sub(unit_r, normal));
    refr_dir = add(refr_dir, muls(sub(refr_target, refr_dir), refr_rough * refr_rough));
    f3 new_dir = safe_normalize(sel(do_spec, spec_dir, sel(do_refr, refr_dir, diffuse_dir)));

    f3 new_ret = add(p.ret, mul(emissive, new_thr));
    f3 color_factor = do_spec ? spec_color : albedo;
    if (!do_refr) new_thr = mul(new_thr, color_factor);
    new_thr = muls(new_thr, inv_prob);

    if (P.roulette != 0) {
        float pr = fminf(fmaxf(fmaxf(new_thr.x, fmaxf(new_thr.y, new_thr.z)), 0.0f), 1.0f);
        float rr = rng.next01();
        bool terminated = rr > pr;
        float boost = 1.0f / fmaxf(pr, MIN_RAY_PROBABILITY);
        if (!terminated) new_thr = muls(new_thr, boost);
        if (P.roulette == 1 && terminated) update = false;
    }

    if (update) {
        p.ret = new_ret;
        p.thr = new_thr;
        p.pos = new_pos;
        p.dir = new_dir;
    }
    p.alive = update;
}

__global__ void __launch_bounds__(128)
render_planes_kernel(Params P, const float* __restrict__ quad_tbl,
                     const float* __restrict__ sph_tbl,
                     const float* __restrict__ mat_tbl,
                     const float* __restrict__ cam_tbl, float* __restrict__ out) {
    extern __shared__ float smem[];
    float* quads = smem;
    float* sph = quads + P.nq * QUAD_COLS;
    float* inv_r = sph + P.ns * SPH_COLS;
    float* mats = inv_r + P.ns;
    float* cam = mats + P.nm * MAT_COLS;

    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nthreads = blockDim.x * blockDim.y;
    for (int i = tid; i < P.nq * QUAD_COLS; i += nthreads) quads[i] = quad_tbl[i];
    for (int i = tid; i < P.ns * SPH_COLS; i += nthreads) sph[i] = sph_tbl[i];
    for (int i = tid; i < P.nm * MAT_COLS; i += nthreads) mats[i] = mat_tbl[i];
    for (int i = tid; i < CAM_COLS; i += nthreads) cam[i] = cam_tbl[i];
    // 1/r rounded from float64, as the JAX main path's baked constant
    for (int i = tid; i < P.ns; i += nthreads)
        inv_r[i] = (float)(1.0 / (double)sph_tbl[i * SPH_COLS + 3]);
    __syncthreads();

    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = blockIdx.y * blockDim.y + threadIdx.y;
    if (col >= P.width || row >= P.height) return;

    const int fy_i = (P.height - 1) - row;
    const float frag_x = (float)col;
    const float frag_y = (float)fy_i;
    const int n_draws = (P.env_draws ? 2 : 0) + 1 + 2 * (P.zangle ? 2 : 3) +
                        (P.roulette != 0 ? 1 : 0);

    Rng rng;
    rng.counter = P.counter_rng != 0;
    rng.state = 0u;
    rng.ctr = 0u;
    rng.key0 = (uint32_t)col * 1973u + (uint32_t)fy_i * 9277u;
    rng.key1 = 0u;

    auto camera_ray = [&](f3& pos, f3& dir) {
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
        dir = safe_normalize(mk(u, v, cam[4] * cam[3]));
    };

    f3 acc = mk(0.0f, 0.0f, 0.0f);
    Path p;
    f3 pos0, dir0;
    if (!rng.counter) {
        rng.state = ((uint32_t)col * 1973u + (uint32_t)fy_i * 9277u +
                     (uint32_t)P.frame * 26699u) | 1u;
        // the jittered ray is drawn once per frame, shared by the spp loop
        camera_ray(pos0, dir0);
    }
    for (int s = 0; s < P.spp; ++s) {
        if (rng.counter) {
            rng.key1 = (uint32_t)P.frame * 26699u +
                       (uint32_t)(s + P.sample0) * 40503u + 1u;
            rng.ctr = 0u;
            camera_ray(pos0, dir0);
        }
        // skipping a dead segment skips its draws: legal for every counter
        // sample and for the wang stream's last sample only
        const bool allow_exit = P.early_exit && (rng.counter || s == P.spp - 1);
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
        for (int seg = 0; seg <= P.bounces; ++seg) {
            if (!p.alive) {
                if (allow_exit) break;
                rng.skip(n_draws);  // a dead segment only advances the stream
                continue;
            }
            bounce(p, rng, P, quads, sph, inv_r, mats, cam);
        }
        acc = add(acc, muls(p.ret, P.inv_spp));
    }

    const size_t n = (size_t)P.width * P.height;
    const size_t i = (size_t)row * P.width + col;
    out[i] = acc.x;
    out[n + i] = acc.y;
    out[2 * n + i] = acc.z;
    out[3 * n + i] = p.miss_dir.x;
    out[4 * n + i] = p.miss_dir.y;
    out[5 * n + i] = p.miss_dir.z;
    out[6 * n + i] = p.miss_thr.x;
    out[7 * n + i] = p.miss_thr.y;
    out[8 * n + i] = p.miss_thr.z;
    out[9 * n + i] = p.jr;
    out[10 * n + i] = p.jc;
    out[11 * n + i] = p.missed ? 1.0f : 0.0f;
}

}  // namespace

extern "C" int cprt_render_planes(const float* quad_tbl, int nq, const float* sph_tbl, int ns,
                                  const float* mat_tbl, int nm, const float* cam_tbl,
                                  float* out, int width, int height, int frame, int sample0,
                                  int spp, int bounces, int counter_rng, int env_draws,
                                  int env_none, int roulette, int zangle, int jitter,
                                  int early_exit, float aspect, float inv_spp,
                                  void* stream) {
    Params P{width, height, frame, sample0, spp, bounces, nq, ns, nm,
             counter_rng, env_draws, env_none, roulette, zangle, jitter,
             early_exit, aspect, inv_spp};
    const size_t smem =
        (size_t)(nq * QUAD_COLS + ns * SPH_COLS + ns + nm * MAT_COLS + CAM_COLS) *
        sizeof(float);
    const dim3 block(32, 4);
    const dim3 grid((width + 31) / 32, (height + 3) / 4);
    render_planes_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
        P, quad_tbl, sph_tbl, mat_tbl, cam_tbl, out);
    return (int)cudaGetLastError();
}

extern "C" const char* cprt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
