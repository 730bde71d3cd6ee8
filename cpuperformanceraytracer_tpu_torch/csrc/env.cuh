// The env map's uv of a miss direction, shared by kernels B
// (env_accumulate.cu) and E (env_gather.cu): the JAX lookup
// (texture/texture.py) step for step, in f32 without fast math.

#pragma once

#include <cuda_runtime.h>

namespace cprt_env {

__device__ __forceinline__ float saturate(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// fract((atan2(z, x), asin(y)) * (0.1591, 0.3183) + 0.5), saturated (the
// truncated constants are the reference's).
__device__ __forceinline__ void equirect_uv(float dx, float dy, float dz, float& u, float& v) {
    u = atan2f(dz, dx) * 0.1591f + 0.5f;
    v = asinf(fminf(fmaxf(dy, -1.0f), 1.0f)) * 0.3183f + 0.5f;
    u = saturate(u - floorf(u));
    v = saturate(v - floorf(v));
}

// Max-axis face select onto six faces stacked vertically (px nx py ny pz
// nz). Ties: X, overridden by Y when |y| >= |x|, by Z when |z| >= |x| and
// |z| >= |y|. The reference looks the cubemap up with the unflipped
// direction.
__device__ __forceinline__ void cubemap_uv(float dx, float dy, float dz, float& u, float& v) {
    const float ax = fabsf(dx), ay = fabsf(dy), az = fabsf(dz);
    float fu = dx >= 0.0f ? -dz : dz;
    float fv = dy;
    float off = dx >= 0.0f ? 0.0f : (float)(1.0 / 6.0);
    if (ay >= ax) {
        fu = dx;
        fv = dy >= 0.0f ? -dz : dz;
        off = dy >= 0.0f ? (float)(2.0 / 6.0) : (float)(3.0 / 6.0);
    }
    if (az >= ax && az >= ay) {
        fu = dz >= 0.0f ? dx : -dx;
        fv = dy;
        off = dz >= 0.0f ? (float)(4.0 / 6.0) : (float)(5.0 / 6.0);
    }
    const float m = fmaxf(ax, fmaxf(ay, az));
    u = saturate(fu / m * 0.5f + 0.5f);
    v = saturate(fv / m * 0.5f + 0.5f);
    v = saturate(v * (float)(1.0 / 6.0) + off);
}

// The uv of kernel A's miss direction: a cubemap, or an equirect map
// after the optional (-x, y, -z) flip.
__device__ __forceinline__ void env_uv(float dx, float dy, float dz, int cubemap, int flip,
                                       float& u, float& v) {
    if (cubemap) {
        cubemap_uv(dx, dy, dz, u, v);
    } else {
        if (flip) {
            dx = -dx;
            dz = -dz;
        }
        equirect_uv(dx, dy, dz, u, v);
    }
}

}  // namespace cprt_env
