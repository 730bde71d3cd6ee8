// Kernel B: deferred env resolve plus progressive accumulate (sm_90a).
//
// Replaces, on the JAX main path, texture.py::env_texel_flat_index +
// texture.py::_gather + the combine at megakernel.py:1163 +
// render/frame.py::accumulate_frame. On the TPU those are XLA ops around
// the Pallas megakernel; here they are one pass per pixel over kernel A's
// planes:
//
//   1. optional (-x, y, -z) flip of the miss direction;
//   2. equirect uv: fract((atan2(z,x), asin(y)) * (0.1591, 0.3183) + .5),
//      saturated (the truncated constants are the reference's);
//   3. stochastic index floor(row+jr)*W + floor(col+jc), or nearest with a
//      clamped truncation; then the FLAT index is clamped to [0, H*W-1]
//      (JAX's clip-mode gather: u = 1 may wrap into the next row);
//   4. one f32 load per channel;
//   5. color = rgb + env * miss_thr (a never-missed pixel has miss_thr 0);
//   6. accum += (color - accum) * blend in place.
//
// What bounds it: memory traffic, 11 plane reads, 3 accumulator reads and
// writes and 3 texel loads per pixel (~72 bytes), at a few dozen flops.
// Fusing the steps makes the planes' round trip one read; the texel loads
// hit L2 (a 512x256 env is 1.5 MB).
//
// Built like kernel A: --fmad=false, no fast math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float saturate(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

__global__ void __launch_bounds__(256)
env_accumulate_kernel(const float* __restrict__ planes, int n, const float* __restrict__ tex_r,
                      const float* __restrict__ tex_g, const float* __restrict__ tex_b,
                      int tex_w, int tex_h, float* __restrict__ accum, float blend,
                      int env, int stochastic, int flip,
                      int64_t* __restrict__ index_out) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n) return;
    float cr = planes[p];
    float cg = planes[n + p];
    float cb = planes[2 * n + p];
    if (env) {
        float dx = planes[3 * n + p];
        float dy = planes[4 * n + p];
        float dz = planes[5 * n + p];
        if (flip) {
            dx = -dx;
            dz = -dz;
        }
        float u = atan2f(dz, dx) * 0.1591f + 0.5f;
        float v = asinf(fminf(fmaxf(dy, -1.0f), 1.0f)) * 0.3183f + 0.5f;
        u = saturate(u - floorf(u));
        v = saturate(v - floorf(v));
        int64_t idx;
        if (stochastic) {
            const float row = v * (float)(tex_h - 1);
            const float col = u * (float)(tex_w - 1);
            idx = (int64_t)floorf(row + planes[9 * n + p]) * tex_w +
                  (int64_t)floorf(col + planes[10 * n + p]);
        } else {
            const int row = min(max((int)(v * (float)(tex_h - 1)), 0), tex_h - 1);
            const int col = min(max((int)(u * (float)(tex_w - 1)), 0), tex_w - 1);
            idx = (int64_t)row * tex_w + col;
        }
        const int64_t last = (int64_t)tex_w * tex_h - 1;
        idx = idx < 0 ? 0 : (idx > last ? last : idx);
        if (index_out) index_out[p] = idx;
        cr = cr + tex_r[idx] * planes[6 * n + p];
        cg = cg + tex_g[idx] * planes[7 * n + p];
        cb = cb + tex_b[idx] * planes[8 * n + p];
    }
    const float ar = accum[p], ag = accum[n + p], ab = accum[2 * n + p];
    accum[p] = ar + (cr - ar) * blend;
    accum[n + p] = ag + (cg - ag) * blend;
    accum[2 * n + p] = ab + (cb - ab) * blend;
}

}  // namespace

extern "C" int cprt_env_accumulate(const float* planes, int n, const float* tex_r,
                                   const float* tex_g, const float* tex_b, int tex_w,
                                   int tex_h, float* accum, float blend, int env,
                                   int stochastic, int flip, int64_t* index_out,
                                   void* stream) {
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    env_accumulate_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        planes, n, tex_r, tex_g, tex_b, tex_w, tex_h, accum, blend, env, stochastic, flip,
        index_out);
    return (int)cudaGetLastError();
}
