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
// as the JAX package does it outside its kernel. Any H and W: one thread
// per value, so no tile shape to divide (the TPU kernel falls back to XLA
// on awkward shapes).
//
// What bounds it: memory traffic, 12 bytes read and 12 written per pixel;
// powf is a few dozen instructions, far under the byte time. Exact
// division and powf (no fast math, --fmad=false): powf may differ from
// torch's CUDA pow by an ulp, so the u8 output is what parity is held to.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float saturate(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

__global__ void __launch_bounds__(256)
tonemap_kernel(const float* __restrict__ in, float* __restrict__ out, int n, float exposure) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float x = in[i] * exposure;
    x = saturate((x * (2.51f * x + 0.03f)) / (x * (2.43f * x + 0.59f) + 0.14f));
    x = saturate(x);
    const float lo = x * 12.92f;
    const float hi = 1.055f * powf(fmaxf(x, 1e-10f), (float)(1.0 / 2.4)) - 0.055f;
    out[i] = x < 0.0031308f ? lo : hi;
}

}  // namespace

extern "C" int cprt_tonemap(const float* in, float* out, int n, float exposure, void* stream) {
    const int threads = 256;
    tonemap_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        in, out, n, exposure);
    return (int)cudaGetLastError();
}
