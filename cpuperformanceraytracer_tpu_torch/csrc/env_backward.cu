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
// TPU scatters serialise. On Hopper it is one pass with native f32
// atomics into d_tex, which the wrapper zeroes. The order of the sums
// varies from run to run.
//
// What bounds it: memory traffic (g, mt and cot_mt planes, the int64
// index, the texel loads and the atomics into a table that fits in L2).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(256)
env_backward_kernel(const float* __restrict__ g, const int64_t* __restrict__ idx,
                    const float* __restrict__ mt, const float* __restrict__ tex_r,
                    const float* __restrict__ tex_g, const float* __restrict__ tex_b,
                    float* __restrict__ cot_mt, float* __restrict__ d_r,
                    float* __restrict__ d_g, float* __restrict__ d_b, int n) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n) return;
    const int64_t t = idx[p];
    const float gr = g[p], gg = g[n + p], gb = g[2 * n + p];
    cot_mt[p] = gr * tex_r[t];
    cot_mt[n + p] = gg * tex_g[t];
    cot_mt[2 * n + p] = gb * tex_b[t];
    atomicAdd(&d_r[t], gr * mt[p]);
    atomicAdd(&d_g[t], gg * mt[n + p]);
    atomicAdd(&d_b[t], gb * mt[2 * n + p]);
}

}  // namespace

// g, mt, cot_mt: (3, n) f32; idx: (n,) int64 in [0, T); tex_* and d_*:
// (T,) f32, d_* zeroed by the caller.
extern "C" int cprt_env_backward(const float* g, const int64_t* idx, const float* mt,
                                 const float* tex_r, const float* tex_g, const float* tex_b,
                                 float* cot_mt, float* d_r, float* d_g, float* d_b, int n,
                                 void* stream) {
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    env_backward_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        g, idx, mt, tex_r, tex_g, tex_b, cot_mt, d_r, d_g, d_b, n);
    return (int)cudaGetLastError();
}
