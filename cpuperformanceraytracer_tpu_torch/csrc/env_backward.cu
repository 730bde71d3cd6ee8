// Kernel D: the env branch of the diff sample's backward (sm_90a).
//
// Replaces cpuperformanceraytracer_tpu/diff/segsum.py::segment_sum_sorted
// and the cotangent products around it (kernels/backward.py:642-653). Per
// pixel p, with t = idx[p] the texel kernel B resolved:
//
//   cot_mt[c][p] = g[c][p] * tex[c][t]                  (d colour / d miss_thr)
//   d_tex[c][t] += g[c][p] * mt[c][p]                   (d colour / d texel)
//
// No missed mask, as in JAX: a never-missed pixel has mt = 0 and its
// cot_mt is never read by the adjoint.
//
// The texel sums are taken in a fixed order, as the reference's sort and
// segmented sum: the same inputs give the same bits on every run.
//
//   1. env_runs_kernel: a warp takes 4 x 32 consecutive pixels, 32 at a
//      time, writes cot_mt and sums each run of equal texels in lane order
//      (a segmented scan of 5 shuffle steps). The last lane of a run writes
//      the run as a record (texel, r, g, b) into its fixed slot, chunk * 32
//      + lane; every other slot, and a run whose three sums are +0.0 or
//      -0.0 (a signed zero added to a sum never changes it; a NaN or an Inf
//      is kept), holds the key T, past every texel. The kernel also zeroes
//      the three planes.
//   2. The wrapper sorts the keys with a stable library sort (the reference
//      sorts with XLA outside its kernels, segsum.py:46-80): a texel's
//      records stay in slot order, which is pixel order.
//   3. texel_sums_kernel: one thread a sorted record; the first record of
//      each texel sums the texel's records in sorted order, from +0.0, and
//      writes the three planes (an untouched texel keeps its +0.0).
//
// What bounds it: memory traffic (g, mt and cot_mt planes and the int64
// index, 44 bytes a pixel; a 20-byte record a slot written, sorted and
// read back) and the sort. At 720p every never-missed pixel lands on the
// texel of the default miss direction with a zero addend, and a warp of 32
// neighbouring pixels holds ~23 runs of equal texels, so the run sums
// shrink what the sort carries to the runs. The pixel streams are loaded
// and stored evict-first, so they leave the texture in the caches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PIX = 4;         // chunks of 32 pixels a warp takes
constexpr int LOOK = 8;        // sorted records a texel's thread loads at once
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
env_runs_kernel(const float* __restrict__ g, const int64_t* __restrict__ idx,
                const float* __restrict__ mt, const float* __restrict__ tex_r,
                const float* __restrict__ tex_g, const float* __restrict__ tex_b,
                float* __restrict__ cot_mt, int* __restrict__ keys, float4* __restrict__ recs,
                float* __restrict__ d_r, float* __restrict__ d_g, float* __restrict__ d_b,
                int n, int t) {
    for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < t;
         i += (long long)gridDim.x * THREADS)
        d_r[i] = d_g[i] = d_b[i] = 0.0f;
    const float* const tex[3] = {tex_r, tex_g, tex_b};
    const int lane = threadIdx.x & 31;
    const long long chunk0 = (((long long)blockIdx.x * THREADS + threadIdx.x) >> 5) * PIX;
    const size_t sn = (size_t)n;

    int key[PIX];     // the texel, -1 past n
    float v[PIX][3];  // the addends g * mt
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
        const long long p = (chunk0 + k) * 32 + lane;
        key[k] = -1;
        v[k][0] = v[k][1] = v[k][2] = 0.0f;
        if (p < n) {
            key[k] = (int)__ldcs((const long long*)idx + p);
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                const float gv = __ldcs(g + c * sn + p);
                __stcs(cot_mt + c * sn + p, gv * __ldg(tex[c] + key[k]));
                v[k][c] = gv * __ldcs(mt + c * sn + p);
            }
        }
    }
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
        if ((chunk0 + k) * 32 >= n) break;  // warp-uniform: no slots past n
        const int prev = __shfl_up_sync(FULL, key[k], 1);
        const int next = __shfl_down_sync(FULL, key[k], 1);
        const unsigned heads = __ballot_sync(FULL, lane == 0 || prev != key[k]);
        const int start = 31 - __clz(heads & ((2u << lane) - 1u));  // the run's first lane
        float sum[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            float x = v[k][c];
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const float up = __shfl_up_sync(FULL, x, d);
                if (lane - d >= start) x = up + x;
            }
            sum[c] = x;
        }
        const bool last = lane == 31 || next != key[k];
        const bool keep =
            last && key[k] >= 0 && (sum[0] != 0.0f || sum[1] != 0.0f || sum[2] != 0.0f);
        const long long slot = (chunk0 + k) * 32 + lane;
        keys[slot] = keep ? key[k] : t;
        if (keep) recs[slot] = make_float4(sum[0], sum[1], sum[2], 0.0f);
    }
}

__global__ void __launch_bounds__(THREADS)
texel_sums_kernel(const int* __restrict__ sorted, const int64_t* __restrict__ order,
                  const float4* __restrict__ recs, int m, int t, float* __restrict__ d_r,
                  float* __restrict__ d_g, float* __restrict__ d_b) {
    const int head = blockIdx.x * THREADS + threadIdx.x;
    if (head >= m) return;
    const int texel = __ldg(sorted + head);
    if (texel >= t || (head > 0 && __ldg(sorted + head - 1) == texel)) return;
    // in sorted order, LOOK records at a time: their loads are issued
    // together, so a texel of many records (the busiest has some hundred)
    // waits for a few latencies per LOOK records (loading the slots with
    // the keys, and 16 at a time, measured slower)
    float r = 0.0f, g = 0.0f, b = 0.0f;
    for (int j = head; j < m; j += LOOK) {
        int n_mine = 0;
        float4 x[LOOK];
#pragma unroll
        for (int u = 0; u < LOOK; ++u)
            if (j + u < m && __ldg(sorted + j + u) == texel) n_mine = u + 1;
#pragma unroll
        for (int u = 0; u < LOOK; ++u)
            if (u < n_mine) x[u] = recs[__ldg(order + j + u)];
#pragma unroll
        for (int u = 0; u < LOOK; ++u) {
            if (u < n_mine) {
                r = r + x[u].x;
                g = g + x[u].y;
                b = b + x[u].z;
            }
        }
        if (n_mine < LOOK) break;
    }
    d_r[texel] = r;
    d_g[texel] = g;
    d_b[texel] = b;
}

}  // namespace

// Records of runs: g, mt, cot_mt (3, n) f32; idx (n,) int64 in [0, t),
// t < 2^31; tex_* (t,) f32; keys (m,) int32 and recs (m, 4) f32 with
// m = ceil(n / 32) * 32 slots; d_* (t,) f32, zeroed here.
extern "C" int cprt_env_backward_runs(const float* g, const int64_t* idx, const float* mt,
                                      const float* tex_r, const float* tex_g,
                                      const float* tex_b, float* cot_mt, int* keys,
                                      float* recs, float* d_r, float* d_g, float* d_b, int n,
                                      int t, void* stream) {
    const int per_block = THREADS * PIX;
    const int blocks = n > 0 ? (n + per_block - 1) / per_block : 1;  // 1: zero the planes
    env_runs_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        g, idx, mt, tex_r, tex_g, tex_b, cot_mt, keys, (float4*)recs, d_r, d_g, d_b, n, t);
    return (int)cudaGetLastError();
}

// The texel sums: ``sorted`` the m keys in ascending order, ``order`` their
// slots (a stable sort's indices); d_*: (t,) f32.
extern "C" int cprt_env_backward_sums(const int* sorted, const int64_t* order,
                                      const float* recs, int m, int t, float* d_r, float* d_g,
                                      float* d_b, void* stream) {
    if (m <= 0) return 0;
    texel_sums_kernel<<<(m + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
        sorted, order, (const float4*)recs, m, t, d_r, d_g, d_b);
    return (int)cudaGetLastError();
}
