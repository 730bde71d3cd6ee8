// Kernel G: the display transform, exposure -> ACES -> sRGB (sm_90a).
//
// Replaces cpuperformanceraytracer_tpu/kernels/tonemap.py::postprocess_pallas
// (a Pallas kernel over (8, 256) tiles). Per value of the (3, H, W) f32
// accumulator:
//
//   x = accum * exposure
//   x = saturate(x * (2.51 x + 0.03) / (x * (2.43 x + 0.59) + 0.14))   ACES
//   x < 0.0031308 ? 12.92 x : 1.055 * pow(max(x, 1e-10), 1/2.4) - 0.055
//
// into a (3, H, W) f32 output in [0, 1]; the round to u8 stays a torch op,
// as the JAX package does it outside its kernel. Any H and W (the TPU
// kernel falls back to XLA on awkward shapes).
//
// What bounds it: memory traffic, 12 bytes read and 12 written per pixel;
// powf is a few dozen instructions, far under the byte time. To keep
// enough bytes in flight on every SM, a thread moves values four at a time
// with 16-byte loads and stores, two such vectors an iteration, over a
// grid of 8 blocks of 256 threads per SM that strides through the values;
// the last 3 * H * W mod 4 values (and buffers that are not 16-byte
// aligned) take the one-value path. Exact division and powf (no fast math,
// --fmad=false): powf may differ from torch's CUDA pow by an ulp, so the
// u8 output is what parity is held to.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;

__device__ __forceinline__ float saturate(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

__device__ __forceinline__ float display(float v, float exposure) {
    float x = v * exposure;
    x = saturate((x * (2.51f * x + 0.03f)) / (x * (2.43f * x + 0.59f) + 0.14f));
    x = saturate(x);
    const float lo = x * 12.92f;
    const float hi = 1.055f * powf(fmaxf(x, 1e-10f), (float)(1.0 / 2.4)) - 0.055f;
    return x < 0.0031308f ? lo : hi;
}

__device__ __forceinline__ float4 display4(float4 v, float exposure) {
    return make_float4(display(v.x, exposure), display(v.y, exposure), display(v.z, exposure),
                       display(v.w, exposure));
}

__global__ void __launch_bounds__(THREADS)
tonemap_kernel(const float* __restrict__ in, float* __restrict__ out, long long n,
               long long n4, float exposure) {
    const long long stride = (long long)gridDim.x * THREADS;
    long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    const float4* in4 = reinterpret_cast<const float4*>(in);
    float4* out4 = reinterpret_cast<float4*>(out);
    for (; i + stride < n4; i += 2 * stride) {
        const float4 a = in4[i], b = in4[i + stride];
        out4[i] = display4(a, exposure);
        out4[i + stride] = display4(b, exposure);
    }
    if (i < n4) out4[i] = display4(in4[i], exposure);
    for (long long j = 4 * n4 + (long long)blockIdx.x * THREADS + threadIdx.x; j < n;
         j += stride)
        out[j] = display(in[j], exposure);
}

}  // namespace

extern "C" int cprt_tonemap(const float* in, float* out, int n, float exposure, void* stream) {
    if (n <= 0) return 0;
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    const bool aligned = ((uintptr_t)in % 16 == 0) && ((uintptr_t)out % 16 == 0);
    const long long n4 = aligned ? n / 4 : 0;
    const long long want = ((n4 > 0 ? n4 : n) + THREADS - 1) / THREADS;
    const int blocks = (int)(want < (long long)sms * BLOCKS_PER_SM ? want
                                                                  : (long long)sms * BLOCKS_PER_SM);
    tonemap_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(in, out, n, n4, exposure);
    return (int)cudaGetLastError();
}
