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
// On the TPU the texel sum is a sort, a prefix sum and a gather, because
// TPU scatters serialise. On Hopper it is one pass of f32 atomics; the
// order in which they arrive varies from run to run.
//
// What bounds it: memory traffic (g, mt and cot_mt planes and the int64
// index, 44 bytes a pixel), the atomics, and the device operations a call
// takes. At 720p every never-missed pixel (mt = 0) lands on the texel of
// the default miss direction, thousands of them, and a warp of 32
// neighbouring pixels holds ~23 runs of equal texels. So:
//
// - a run whose sum is +0.0 or -0.0 in all three channels issues no
//   atomic (a signed zero added to a sum that starts at +0.0 never
//   changes it; a NaN or an Inf still goes through);
// - a warp takes 4 x 32 consecutive pixels, 32 at a time, so each load,
//   gather and atomic instruction covers 32 neighbouring pixels; it sums
//   each run of equal indices with a segmented scan of 5 shuffle steps,
//   and the last lane of a run issues one float4 atomicAdd (a vector red
//   on sm_90) of its three sums into a (T, 4) scratch: one L2
//   transaction for the three channels. The order of a sum inside a warp
//   is fixed by lane order;
// - the streams are loaded and stored evict-first, so they leave the
//   texture and the scratch in the caches;
// - three kernels: one zeroes the scratch, the scatter, and one unpacks
//   the scratch into the three planes. The last two are launched with
//   programmatic dependent launch: the scatter's blocks start while the
//   scratch is being zeroed and wait for it (griddepcontrol.wait) only
//   before their atomics; the unpack waits for the scatter.
//
// Measured on the H100 against other designs (PERF.md): 4 neighbouring
// pixels a thread with 16-byte loads, a red per channel into the planes,
// or one cooperative kernel with two grid barriers were slower.

#include <cuda_runtime.h>
#include <stdint.h>

// programmatic dependent launch (sm_90): wait for the grid launched
// before on the stream, and let the next grid launch early
#define PDL_WAIT() asm volatile("griddepcontrol.wait;" ::: "memory")
#define PDL_TRIGGER() asm volatile("griddepcontrol.launch_dependents;")

namespace {

constexpr int PIX = 4;         // pixels a lane takes, 32 apart
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
env_backward_kernel(const float* __restrict__ g, const int64_t* __restrict__ idx,
                    const float* __restrict__ mt, const float* __restrict__ tex_r,
                    const float* __restrict__ tex_g, const float* __restrict__ tex_b,
                    float* __restrict__ cot_mt, float4* __restrict__ sums, int n) {
    const float* const tex[3] = {tex_r, tex_g, tex_b};
    const int lane = threadIdx.x & 31;
    const long long base = (((long long)blockIdx.x * THREADS + threadIdx.x) >> 5) * (32 * PIX);
    const size_t sn = (size_t)n;

    int key[PIX];     // the texel, -1 past n
    float v[PIX][3];  // the addends g * mt
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
        const long long p = base + k * 32 + lane;
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
    PDL_WAIT();  // the zeroed scratch
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
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
        if (last && key[k] >= 0 && (sum[0] != 0.0f || sum[1] != 0.0f || sum[2] != 0.0f))
            atomicAdd(sums + key[k], make_float4(sum[0], sum[1], sum[2], 0.0f));
    }
}

__global__ void __launch_bounds__(THREADS)
unpack_kernel(const float4* __restrict__ sums, float* __restrict__ d_r,
              float* __restrict__ d_g, float* __restrict__ d_b, int t) {
    PDL_WAIT();
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= t) return;
    const float4 s = sums[i];
    d_r[i] = s.x;
    d_g[i] = s.y;
    d_b[i] = s.z;
}

__global__ void __launch_bounds__(THREADS) zero_kernel(float4* __restrict__ sums, int t) {
    PDL_TRIGGER();  // the scatter may start its loads now
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i < t) sums[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// Launch ``kernel`` on ``st`` after the grid before it, with programmatic
// stream serialisation: it may start before that grid ends, and waits for
// it where it executes PDL_WAIT.
template <typename... KArgs, typename... Args>
int launch_pdl(void (*kernel)(KArgs...), int blocks, cudaStream_t st, Args... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (err != cudaSuccess) cudaGetLastError();  // clear it: the caller reports it
    return (int)err;
}

}  // namespace

// g, mt, cot_mt: (3, n) f32; idx: (n,) int64 in [0, t), t < 2^31; tex_*
// and d_*: (t,) f32; sums: (t, 4) f32 scratch, 16-byte aligned.
extern "C" int cprt_env_backward(const float* g, const int64_t* idx, const float* mt,
                                 const float* tex_r, const float* tex_g, const float* tex_b,
                                 float* cot_mt, float* d_r, float* d_g, float* d_b, int n,
                                 float* sums, int t, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (t <= 0) return 0;
    zero_kernel<<<(t + THREADS - 1) / THREADS, THREADS, 0, st>>>((float4*)sums, t);
    int err = (int)cudaGetLastError();
    if (err) return err;
    if (n > 0) {
        const int per_block = THREADS * PIX;
        err = launch_pdl(env_backward_kernel, (n + per_block - 1) / per_block, st, g, idx, mt,
                         tex_r, tex_g, tex_b, cot_mt, (float4*)sums, n);
        if (err) return err;
    }
    return launch_pdl(unpack_kernel, (t + THREADS - 1) / THREADS, st, (const float4*)sums, d_r,
                      d_g, d_b, t);
}
