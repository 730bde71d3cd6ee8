// Kernel F: multi-sample env combine plus progressive accumulate (sm_90a).
//
// Replaces cpuperformanceraytracer_tpu/kernels/combine.py::combine_accumulate
// (a Pallas kernel). Per pixel and channel c, in place on the planar
// (3, H, W) accumulator:
//
//   spp == 1:  color = rgb_c + env_c * thr_c
//   spp > 1:   env_sum = sum_s env_{s,c} * thr_{s,c}      (s in order)
//              color = rgb_c + env_sum * (1/spp)
//   accum_c += (color - accum_c) * blend
//
// with the TPU kernel's operation order. env is kernel E's (P, 4) RGBX rows
// (one slab per sample, e_stride floats apart); rgb and thr are kernel A's
// per-sample rgb and miss-throughput planes, one (3, H, W) slab per sample
// rgb_stride and thr_stride floats apart, so the planes of kernel A's (spp,
// 12, H, W) buffer are read where they lie. The rgb mean is taken here as
// kernel A takes it in its own sample loop: sum_s rgb_s * (1/spp), from 0 in
// order. At spp = 1 the one loop gives rgb + env * thr bit for bit (0 + x
// and x * 1 are exact), the JAX kernel's spp = 1 form.
//
// What bounds it: memory traffic. At spp samples a pixel reads spp * (16 +
// 12 + 12) bytes and reads and writes 12 bytes of accumulator, at a few
// flops each. The TPU kernel's lane-shuffle deinterleave of the RGBX rows
// has no counterpart: a thread loads its pixel's row as one float4.
//
// Built with --fmad=false and no fast math, as kernels A and B.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(256)
combine_kernel(const float4* __restrict__ e4, int64_t e_stride, const float* __restrict__ rgb,
               int64_t rgb_stride, const float* __restrict__ thr, int64_t thr_stride,
               float* __restrict__ accum, int n, int spp, float inv_spp, float blend) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n) return;
    float env_sum[3] = {0.0f, 0.0f, 0.0f};
    float mean[3] = {0.0f, 0.0f, 0.0f};
    for (int s = 0; s < spp; ++s) {
        const float4 e = e4[s * e_stride + p];
        const float* t = thr + s * thr_stride;
        const float* r = rgb + s * rgb_stride;
        env_sum[0] = env_sum[0] + e.x * t[p];
        env_sum[1] = env_sum[1] + e.y * t[n + p];
        env_sum[2] = env_sum[2] + e.z * t[2 * n + p];
#pragma unroll
        for (int c = 0; c < 3; ++c) mean[c] = mean[c] + r[c * n + p] * inv_spp;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        const float color = mean[c] + env_sum[c] * inv_spp;
        const float a = accum[c * n + p];
        accum[c * n + p] = a + (color - a) * blend;
    }
}

}  // namespace

// Strides are in floats; e_stride is a multiple of 4 (the RGBX rows).
extern "C" int cprt_combine(const float* e4, long long e_stride, const float* rgb,
                            long long rgb_stride, const float* thr, long long thr_stride,
                            float* accum, int n, int spp, float inv_spp, float blend,
                            void* stream) {
    const int threads = 256;
    combine_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(e4), (int64_t)(e_stride / 4), rgb, (int64_t)rgb_stride,
        thr, (int64_t)thr_stride, accum, n, spp, inv_spp, blend);
    return (int)cudaGetLastError();
}
