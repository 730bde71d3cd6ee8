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
// A pixel is a sequence of steps, each of which runs segment() (the nearest
// hit over all quads and spheres, and the shading) once:
//   1. replay: segment k at the stored input state of segment k; while the
//      path lives, advance() gives the state of segment k + 1, pushed on the
//      pixel's stack. The replay stops where the path dies or after
//      bounces + 1 segments (a dead segment is an identity, so its adjoint
//      is too: the TPU kernel copies dead segments, backward.py:404-426).
//   2. reverse: the last live segment's adjoint is applied in the step that
//      found it last; then every earlier segment k is run again at its
//      stored state, with rng.ctr = ctr0 + k * n_draws, and its hand-derived
//      adjoint applied (CUDA has no jax.vjp): hit geometry, Beer
//      absorption, reflect, refract, the roughness lerps, safe_normalize,
//      emissive and colour factor.
//   3. after segment 0's adjoint, the camera adjoint.
// A launch replays a window of pixel rows (Params::row0, local_height; the
// whole image is row0 = 0, local_height = height), as the TPU kernel under
// shard_map (backward.py:350-353): its pixels are the window's, cot6 holds
// the window's rows, and each pixel keys its RNG and casts its camera ray
// from its global row, as kernel A's window does.
// start_pixel, step_segment and step_finish are plain C++ apart from their
// qualifiers, so the host compiler runs the same sequence of steps
// (tests/test_torch_backward.py).
//
// What bounds it on the card: FP32 issue (no FMA: the parity policy builds
// with --fmad=false), about three times kernel A's work per live segment,
// and idle lanes: with one thread per pixel a warp runs until its longest
// path ends. So the kernel is persistent and regenerates pixels, as kernel
// A: as many 128-thread blocks as are resident, each with the scene tables
// in shared memory; warp w of W takes the chunks of 8 consecutive pixels
// w, w + W, w + 2W, ... in that fixed order, and a lane whose pixel is done
// takes the next pixel of its warp's chunks (a ballot and a popc). A fixed
// order keeps the sums deterministic; chunks of 8 measured faster than 32
// or 16 (more, smaller chunks a warp even out the warps' work), and chunks
// from an atomic counter faster still but in an order that varies from run
// to run (PERF.md). Every
// busy lane runs segment() in every warp-iteration, whether it replays or
// reverses, so the trace runs on all lanes together and only the update or
// the adjoint diverges.
//
// The stack of segment input states (thr, pos, dir: 9 floats) is in shared
// memory, sized by the bounce count: (bounces + 1) x 9 floats a lane,
// lane-interleaved, so a warp's accesses hit 32 banks.
//
// Sums in a fixed order, without atomics: each warp owns a row of all the
// table cells in shared memory. A step's cotangents (a Contrib: one
// material row, one quad or sphere row, the camera row) are summed over
// the lanes that add to the same row (__match_any_sync groups them) by a
// tree in lane order, and the group's lowest lane adds the sums into the
// warp's row with plain shared stores. The chunks a warp takes, its
// lanes' pixels and the order of its steps depend on the data only, so
// every sum is the same from run to run. At the end each block sums its
// warps' rows in warp order into its row of an (n_blocks, n_cells) partials
// tensor, which the wrapper sums over a fixed shape (the counterpart of
// the XLA sum outside the TPU kernel, backward.py:544).
//
// Built like kernel A: --fmad=false, no fast math.

#include "bounce.cuh"

namespace {

using namespace cprt;

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

// What one step adds to the tables: at most one material row, one quad or
// sphere row and the camera row.
constexpr int MAT_SLOTS = 15, GEO_SLOTS = 6;

// The material column of each slot: albedo, specular colour, emissive,
// specular roughness, refraction roughness, ior, refraction colour.
CPRT_HD int mat_col(int slot) {
    return slot < 3 ? slot : slot < 6 ? slot + 5 : slot < 9 ? slot - 3
         : slot == 9 ? 7 : slot == 10 ? 13 : slot == 11 ? 11 : slot + 2;  // 12-14: 14-16
}

struct Contrib {
    int mat_row;   // material row, -1: none
    int geo_cell;  // first cell of the quad or sphere row, -1: none
    int geo_n;     // its cells: 6 (a quad's v0, n) or 4 (a sphere's c, r)
    int cam;       // 1: cam holds cotangents
    float mat[MAT_SLOTS], geo[GEO_SLOTS], camv[CAM_COLS];
};

CPRT_FN void clear(Contrib& c) {
    c.mat_row = c.geo_cell = -1;
    c.geo_n = 0;
    c.cam = 0;
    for (int i = 0; i < MAT_SLOTS; ++i) c.mat[i] = 0.0f;
    for (int i = 0; i < GEO_SLOTS; ++i) c.geo[i] = 0.0f;
    for (int i = 0; i < CAM_COLS; ++i) c.camv[i] = 0.0f;
}

// Add ``c`` into a row of all the cells (``T``: float on the card, double
// in the host harness).
template <class T>
CPRT_FN void add_contrib(T* cells, const Cells& C, const Contrib& c) {
    if (c.mat_row >= 0) {
        T* row = cells + C.mat + c.mat_row * MAT_COLS;
#pragma unroll
        for (int i = 0; i < MAT_SLOTS; ++i) row[mat_col(i)] += c.mat[i];
    }
    if (c.geo_cell >= 0) {
#pragma unroll
        for (int i = 0; i < GEO_SLOTS; ++i)
            if (i < c.geo_n) cells[c.geo_cell + i] += c.geo[i];
    }
    if (c.cam) {
#pragma unroll
        for (int i = 0; i < CAM_COLS; ++i) cells[C.cam + i] += c.camv[i];
    }
}

CPRT_FN void set3(float* v, f3 x) {
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
}

// Reverse one live segment: ``p`` is its input state, ``s`` what it
// computed there; ``a`` holds the cotangents of its outputs on entry and
// of its inputs on return; the table cotangents go into ``out``.
CPRT_FN void segment_adjoint(const Path& p, const Seg& s, const Params& P, const float* quads,
                             const float* sph, const float* inv_r, const float* cam,
                             const Cells& C, Adj& a, Contrib& out) {
    if (s.miss) {
        // first miss: miss_thr = thr, and with env none ret += ambient * thr
        if (P.env_none) {
            out.cam = 1;
            set3(out.camv + 5, mul(a.ret, p.thr));
            a.thr = add(a.thr, mul(a.ret, load3(cam + 5)));
        }
        a.thr = add(a.thr, a.miss_thr);
        return;
    }
    if (!s.update) return;  // terminated by roulette "terminate": an identity

    const float* m = s.m;
    out.mat_row = (int)s.hit.mat;
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
        set3(out.mat + (s.do_spec ? 3 : 0), mul(gt, s.thr1));
    }
    // ret_out = ret + emissive * thr1 (ret passes through)
    set3(out.mat + 6, mul(a.ret, s.thr1));
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
            out.mat[12 + c] = -(g_x * dist);
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
        out.mat[9] = dot(g_raw, sub(s.diffuse_dir, s.spec_refl)) * 2.0f * rough;
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
        out.mat[10] = dot(g_raw, sub(s.refr_target, s.refr_raw)) * 2.0f * rough;
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
            out.mat[11] = inside ? g_eta : -g_eta / (ior * ior);
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
        out.geo_cell = C.quad + obj * QUAD_COLS;
        out.geo_n = 6;
        set3(out.geo, g_off);
        set3(out.geo + 3, g_n);
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
        out.geo_cell = C.sph + obj * SPH_COLS;
        out.geo_n = 4;
        set3(out.geo, neg(g_m));
        out.geo[3] = g_r;
    }
    a.thr = g_thr;
    a.pos = g_pos;
    a.dir = g_dir;
}

// A pixel's stack of segment input states (thr, pos, dir): entry k,
// component j at base[(k * 9 + j) * stride].
struct Stack {
    float* base;
    int stride;

    CPRT_FN void push(int k, f3 thr, f3 pos, f3 dir) {
        const f3 v[3] = {thr, pos, dir};
        for (int j = 0; j < 3; ++j) {
            base[(k * 9 + 3 * j) * stride] = v[j].x;
            base[(k * 9 + 3 * j + 1) * stride] = v[j].y;
            base[(k * 9 + 3 * j + 2) * stride] = v[j].z;
        }
    }
    CPRT_FN f3 get(int k, int j) const {
        return mk(base[(k * 9 + 3 * j) * stride], base[(k * 9 + 3 * j + 1) * stride],
                  base[(k * 9 + 3 * j + 2) * stride]);
    }
};

// One lane's pixel in flight.
struct Lane {
    Rng rng;
    uint32_t ctr0;
    int k;        // the segment this step runs
    bool replay;  // replaying forward, else reversing
    Adj a;
    f3 target;    // the camera ray's direction before normalisation
};

// Cast the camera ray of pixel (col, row), ``row`` the global row of the
// height-row image, and push segment 0's state;
// ``cot`` holds its six output cotangents (d r, d g, d b, d mt xyz).
CPRT_FN void start_pixel(Lane& L, const Params& P, const float* cam, int col, int row,
                         const float* cot, Stack st) {
    counter_keys(L.rng, col, (P.height - 1) - row, frame_of(P), P.sample0);
    f3 pos0, dir0;
    camera_ray(L.rng, P, cam, (float)col, (float)((P.height - 1) - row), pos0, dir0, L.target);
    L.ctr0 = L.rng.ctr;
    st.push(0, mk(1.0f, 1.0f, 1.0f), pos0, dir0);
    L.k = 0;
    L.replay = true;
    // spp = 1: the ret cotangent is the rgb cotangent
    L.a.ret = mk(cot[0], cot[1], cot[2]);
    L.a.thr = L.a.pos = L.a.dir = mk(0.0f, 0.0f, 0.0f);
    L.a.miss_thr = mk(cot[3], cot[4], cot[5]);
}

// The first half of a step: segment L.k at its stored input state.
CPRT_FN void step_segment(Lane& L, const Params& P, const float* quads, const float* sph,
                          const float* inv_r, const float* mats, const float* cam, Stack st,
                          Path& q, Seg& s) {
    q.ret = mk(0.0f, 0.0f, 0.0f);  // only the discarded new_ret reads it
    q.thr = st.get(L.k, 0);
    q.pos = st.get(L.k, 1);
    q.dir = st.get(L.k, 2);
    q.alive = true;
    q.missed = false;
    q.miss_dir = mk(0.0f, 0.0f, 1.0f);
    q.miss_thr = mk(0.0f, 0.0f, 0.0f);
    q.jr = q.jc = 0.0f;
    L.rng.ctr = L.ctr0 + (uint32_t)(L.k * segment_draws(P));
    segment(q, L.rng, P, quads, sph, inv_r, mats, cam, s);
}

// The second half: the replay pushes the next state, or the segment's
// adjoint is applied (and after segment 0's, the camera adjoint). Returns
// true when the pixel is done; its table cotangents of the step go into
// ``out`` (cleared by the caller).
CPRT_FN bool step_finish(Lane& L, const Params& P, const float* quads, const float* sph,
                         const float* inv_r, const float* cam, const Cells& C, Stack st,
                         const Path& q, const Seg& s, Contrib& out) {
    if (L.replay) {
        Path next = q;
        advance(next, s);
        if (next.alive && L.k < P.bounces) {
            st.push(++L.k, next.thr, next.pos, next.dir);
            return false;
        }
        // the last live segment: its adjoint now, from the same intermediates
        L.replay = false;
    }
    segment_adjoint(q, s, P, quads, sph, inv_r, cam, C, L.a, out);
    if (L.k > 0) {
        --L.k;
        return false;
    }
    // camera: pos = cam[0:3]; dir = safe_normalize(u, v, cam[4] * cam[3])
    out.cam = 1;
    set3(out.camv, L.a.pos);
    const f3 g_t = safe_normalize_adj(L.target, L.a.dir);
    out.camv[3] = g_t.z * cam[4];
    out.camv[4] = g_t.z * cam[3];
    return true;
}

#ifdef __CUDACC__

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int MIN_BLOCKS = 4;
constexpr int CHUNK = 8;  // consecutive pixels a warp takes at a time
constexpr unsigned FULL = 0xffffffffu;

// Sum v[0..n) over the lanes that pass the same ``key`` (a tree in lane
// order: each lane's successor in its group found by pointer jumping);
// returns true on the group's lowest lane, which then holds the sums.
template <int N>
__device__ __forceinline__ bool group_sum(int key, float (&v)[N]) {
    const int lane = threadIdx.x & 31;
    const unsigned peers = __match_any_sync(FULL, key);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    const unsigned above = lane == 31 ? 0u : peers & (~0u << (lane + 1));
    int next = above ? __ffs(above) - 1 : -1;  // the peer d ranks above
    const int size = key >= 0 ? __popc(peers) : 1;
    const int biggest = __reduce_max_sync(FULL, size);
    for (int d = 1; d < biggest; d <<= 1) {
        const int src = next < 0 ? lane : next;
        const bool take = next >= 0 && (rank & (2 * d - 1)) == 0;
#pragma unroll
        for (int i = 0; i < N; ++i) {
            const float o = __shfl_sync(FULL, v[i], src);
            if (take) v[i] = v[i] + o;
        }
        const int jump = __shfl_sync(FULL, next, src);
        next = next < 0 ? -1 : jump;
    }
    return rank == 0 && key >= 0;
}

// Every lane of the warp: add the step's cotangents of all lanes into the
// warp's row, in a fixed order.
__device__ __forceinline__ void warp_add(float* row, const Cells& C, Contrib& c) {
    if (__any_sync(FULL, c.mat_row >= 0) && !group_sum(c.mat_row, c.mat)) c.mat_row = -1;
    if (__any_sync(FULL, c.geo_cell >= 0) && !group_sum(c.geo_cell, c.geo)) c.geo_cell = -1;
    if (__any_sync(FULL, c.cam != 0) && !group_sum(c.cam ? 0 : -1, c.camv)) c.cam = 0;
    add_contrib(row, C, c);  // the groups' rows are disjoint
    __syncwarp();
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
bwd_tables_kernel(Params P, const float* __restrict__ quad_tbl,
                  const float* __restrict__ sph_tbl, const float* __restrict__ mat_tbl,
                  const float* __restrict__ cam_tbl, const float* __restrict__ cot6,
                  float* __restrict__ partials, unsigned long long* __restrict__ lane_stats) {
    extern __shared__ float smem[];
    const SceneSmem S = load_scene(P, quad_tbl, sph_tbl, mat_tbl, cam_tbl, smem);
    const Cells C = cell_layout(P.nq, P.ns, P.nm);
    float* rows = smem + scene_smem_floats(P.nq, P.ns, P.nm);
    for (int i = threadIdx.x; i < WARPS * C.n; i += THREADS) rows[i] = 0.0f;
    __syncthreads();

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float* row = rows + warp * C.n;
    const Stack st{rows + WARPS * C.n + threadIdx.x, THREADS};
    const int n = P.width * P.local_height;  // the window's pixels
    const size_t sn = (size_t)n;
    const int n_warps = gridDim.x * WARPS;

    // the warp's chunks: w, w + W, w + 2W, ... (warp-uniform)
    int chunk = blockIdx.x * WARPS + warp;
    int chunk_next = 0, chunk_end = 0;
    bool chunks_left = true;
    bool busy = false;
    int item = 0;
    Lane L;
    unsigned live = 0, slots = 0;

    while (true) {
        // free lanes take the next pixels of the chunk, then of the next chunks
        bool fresh = false;
        unsigned idle = __ballot_sync(FULL, !busy);
        while (idle && chunks_left) {
            if (chunk_next == chunk_end) {
                const int base = chunk * CHUNK;
                if (base >= n) {
                    chunks_left = false;
                    break;
                }
                chunk += n_warps;
                chunk_next = base;
                chunk_end = min(base + CHUNK, n);
            }
            const int take = min(__popc(idle), chunk_end - chunk_next);
            const int rank = __popc(idle & ((1u << lane) - 1u));
            if (!busy && rank < take) {
                item = chunk_next + rank;
                busy = fresh = true;
            }
            chunk_next += take;
            idle = __ballot_sync(FULL, !busy);
        }
        const unsigned active = __ballot_sync(FULL, busy);
        if (active == 0u) break;
        live += __popc(active);
        slots += 32;

        Contrib c;
        clear(c);
        Path q;
        Seg s;
        if (busy) {
            if (fresh) {
                const int r = item / P.width;  // of the window
                float cot[6];
                for (int k = 0; k < 6; ++k) cot[k] = cot6[k * sn + item];
                start_pixel(L, P, S.cam, item - r * P.width, P.row0 + r, cot, st);
            }
            step_segment(L, P, S.quads, S.sph, S.inv_r, S.mats, S.cam, st, q, s);
        }
        if (busy && step_finish(L, P, S.quads, S.sph, S.inv_r, S.cam, C, st, q, s, c))
            busy = false;
        warp_add(row, C, c);
    }
    __syncthreads();
    float* out = partials + (size_t)blockIdx.x * C.n;
    for (int i = threadIdx.x; i < C.n; i += THREADS) {
        float v = rows[i];
        for (int w = 1; w < WARPS; ++w) v += rows[w * C.n + i];
        out[i] = v;
    }
    if (lane_stats != nullptr && lane == 0) {
        atomicAdd(&lane_stats[0], (unsigned long long)live);
        atomicAdd(&lane_stats[1], (unsigned long long)slots);
    }
}

// The kernel may take ``smem`` bytes of dynamic shared memory.
cudaError_t allow_smem(size_t smem) {
    return cudaFuncSetAttribute(bwd_tables_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

size_t smem_bytes(int nq, int ns, int nm, int bounces) {
    const Cells C = cell_layout(nq, ns, nm);
    return (size_t)(scene_smem_floats(nq, ns, nm) + WARPS * C.n +
                    (bounces + 1) * 9 * THREADS) * sizeof(float);
}

// The grid: the blocks resident on the card at this shared memory, at most
// one a 128 pixels. 0 blocks: the scene does not fit.
int grid_blocks(int nq, int ns, int nm, int bounces, int n_px, int* blocks) {
    const size_t smem = smem_bytes(nq, ns, nm, bounces);
    int dev = 0, sms = 0, per_sm = 0, most_smem = 0;
    *blocks = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&most_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess && smem > (size_t)most_smem) return 0;
    if (err == cudaSuccess) err = allow_smem(smem);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bwd_tables_kernel,
                                                            THREADS, smem);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return (int)err;
    }
    const long long needed = ((long long)n_px + THREADS - 1) / THREADS;
    const long long most = (long long)per_sm * sms;
    *blocks = (int)(needed < most ? needed : most);
    return 0;
}

#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__

// The rows of the partials (0 when the scene's tables, the warps' rows and
// the stacks do not fit in a block's shared memory).
extern "C" int cprt_bwd_tables_blocks(int nq, int ns, int nm, int bounces, int width,
                                      int height, int* blocks) {
    return grid_blocks(nq, ns, nm, bounces, width * height, blocks);
}

// Launch on ``stream``; ``partials`` is (blocks, n_cells) f32 with
// ``blocks`` from cprt_bwd_tables_blocks, n_cells = NQ*25 + NS*5 + NM*17 +
// 8. ``lane_stats`` is null or two zeroed u64 (lanes that ran a step, lane
// slots of all warp-iterations); ``frame_base`` is null, or a device int added to ``frame``. The launch
// replays global rows [row0, row0 + local_height) of the height-row image;
// ``cot6`` is (6, local_height, width).
extern "C" int cprt_bwd_tables(const float* quad_tbl, int nq, const float* sph_tbl, int ns,
                               const float* mat_tbl, int nm, const float* cam_tbl,
                               const float* cot6, float* partials, int blocks, int width,
                               int height, int row0, int local_height, int frame,
                               int sample0, int bounces, int env_draws,
                               int env_none, int roulette, int zangle, int jitter,
                               float aspect, unsigned long long* lane_stats,
                               const int* frame_base, void* stream) {
    Params P{width, height, frame, sample0, 1, bounces, nq, ns, nm,
             1, env_draws, env_none, roulette, zangle, jitter,
             aspect, 1.0f, frame_base, row0, local_height};
    if (blocks <= 0 || row0 < 0 || local_height < 0 || row0 + local_height > height)
        return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes(nq, ns, nm, bounces);
    const int err = (int)allow_smem(smem);
    if (err) return err;
    bwd_tables_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
        P, quad_tbl, sph_tbl, mat_tbl, cam_tbl, cot6, partials, lane_stats);
    return (int)cudaGetLastError();
}

#endif  // __CUDACC__
