// Kernel E: the deferred env lookup and the texel fetch (sm_90a).
//
// Replaces cpuperformanceraytracer_tpu/kernels/env_gather.py::_env_gather
// (the MXU one-hot gather, a Pallas kernel) and, on the textured
// multi-sample path, the XLA lookup texture.py::sample_environment_deferred
// around the TPU megakernel. Two entry points share one tap fetch:
//
//   gather_texels: out[i] = (r, g, b, 0) of tex[rows[i], cols[i]], row and
//     column each clamped to its axis. Exact f32 loads: the TPU kernel's
//     bf16 hi/lo split existed only to route the fetch through the MXU.
//   env_lookup: per pixel, kernel A's miss direction (planes 3-5) and env
//     jitter (planes 9-10) -> uv (equirect after the optional x/z flip, or
//     cubemap of the unflipped direction) -> the taps -> one RGBX row:
//       stochastic: floor(row+jr)*W + floor(col+jc), FLAT index clamped to
//                   [0, H*W-1] (JAX's clip-mode gather: u = 1 may wrap);
//       nearest:    truncated row and col, each clamped to its axis;
//       bilinear:   floor/ceil taps clamped per axis, du/dv from the floor
//                   corner, lerp along u then v.
//     A pixel that never missed still looks up its default direction; its
//     miss throughput is 0, so the combine adds 0.
//
// What bounds it: memory traffic. 5 plane reads (20 bytes) and one 16-byte
// row written per pixel, plus 1 or 4 texel taps of 12 bytes that mostly hit
// L2 (a 2048x1024 env is 25 MB, under the 50 MB L2). One thread per pixel,
// neighbouring threads on neighbouring pixels, one float4 store each.
//
// Parity: built with --fmad=false and no fast math, as kernel B; the uv
// arithmetic is the JAX operand order, (dim - 1) as f32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "env.cuh"

namespace {

using cprt_env::env_uv;

enum Sampling { STOCHASTIC = 0, NEAREST = 1, BILINEAR = 2 };

struct Tex {
    const float* r;
    const float* g;
    const float* b;
    int w, h;
};

__device__ __forceinline__ int64_t clamp_axis(int64_t x, int n) {
    return x < 0 ? 0 : (x > n - 1 ? n - 1 : x);
}

__global__ void __launch_bounds__(256)
env_lookup_kernel(const float* __restrict__ planes, int n, Tex t, int cubemap, int sampling,
                  int flip, float4* __restrict__ out, int64_t* __restrict__ taps) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n) return;
    float u, v;
    env_uv(planes[3 * n + p], planes[4 * n + p], planes[5 * n + p], cubemap, flip, u, v);
    const float row = v * (float)(t.h - 1);
    const float col = u * (float)(t.w - 1);
    int64_t i[4];
    float4 o;
    o.w = 0.0f;
    if (sampling == BILINEAR) {
        const float r0f = floorf(row), r1f = ceilf(row);
        const float c0f = floorf(col), c1f = ceilf(col);
        const float dv = row - r0f, du = col - c0f;
        const int64_t r0 = clamp_axis((int64_t)r0f, t.h), r1 = clamp_axis((int64_t)r1f, t.h);
        const int64_t c0 = clamp_axis((int64_t)c0f, t.w), c1 = clamp_axis((int64_t)c1f, t.w);
        i[0] = r0 * t.w + c0;
        i[1] = r0 * t.w + c1;
        i[2] = r1 * t.w + c0;
        i[3] = r1 * t.w + c1;
        const float* ch[3] = {t.r, t.g, t.b};
        float res[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            const float c00 = ch[c][i[0]], c10 = ch[c][i[1]];
            const float c01 = ch[c][i[2]], c11 = ch[c][i[3]];
            const float top = c00 + (c10 - c00) * du;
            const float bot = c01 + (c11 - c01) * du;
            res[c] = top + (bot - top) * dv;
        }
        o.x = res[0];
        o.y = res[1];
        o.z = res[2];
    } else {
        int64_t idx;
        if (sampling == STOCHASTIC) {
            idx = (int64_t)floorf(row + planes[9 * n + p]) * t.w +
                  (int64_t)floorf(col + planes[10 * n + p]);
            const int64_t last = (int64_t)t.w * t.h - 1;
            idx = idx < 0 ? 0 : (idx > last ? last : idx);
        } else {
            idx = clamp_axis((int64_t)row, t.h) * t.w + clamp_axis((int64_t)col, t.w);
        }
        i[0] = i[1] = i[2] = i[3] = idx;
        o.x = t.r[idx];
        o.y = t.g[idx];
        o.z = t.b[idx];
    }
    out[p] = o;
    if (taps) {
#pragma unroll
        for (int k = 0; k < 4; ++k) taps[4 * (int64_t)p + k] = i[k];
    }
}

template <typename I>
__global__ void __launch_bounds__(256)
gather_texels_kernel(Tex t, const I* __restrict__ rows, const I* __restrict__ cols, int n,
                     float4* __restrict__ out) {
    const int q = blockIdx.x * blockDim.x + threadIdx.x;
    if (q >= n) return;
    const int64_t idx = clamp_axis((int64_t)rows[q], t.h) * t.w + clamp_axis((int64_t)cols[q], t.w);
    out[q] = make_float4(t.r[idx], t.g[idx], t.b[idx], 0.0f);
}

}  // namespace

extern "C" int cprt_env_lookup(const float* planes, int n, const float* tex_r,
                               const float* tex_g, const float* tex_b, int tex_w, int tex_h,
                               int cubemap, int sampling, int flip, float* out, int64_t* taps,
                               void* stream) {
    const Tex t{tex_r, tex_g, tex_b, tex_w, tex_h};
    const int threads = 256;
    env_lookup_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        planes, n, t, cubemap, sampling, flip, reinterpret_cast<float4*>(out), taps);
    return (int)cudaGetLastError();
}

extern "C" int cprt_gather_texels(const float* tex_r, const float* tex_g, const float* tex_b,
                                  int tex_w, int tex_h, const void* rows, const void* cols,
                                  int idx64, int n, float* out, void* stream) {
    const Tex t{tex_r, tex_g, tex_b, tex_w, tex_h};
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    float4* o = reinterpret_cast<float4*>(out);
    if (idx64) {
        gather_texels_kernel<int64_t><<<blocks, threads, 0, (cudaStream_t)stream>>>(
            t, (const int64_t*)rows, (const int64_t*)cols, n, o);
    } else {
        gather_texels_kernel<int32_t><<<blocks, threads, 0, (cudaStream_t)stream>>>(
            t, (const int32_t*)rows, (const int32_t*)cols, n, o);
    }
    return (int)cudaGetLastError();
}
