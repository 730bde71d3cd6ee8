// K6: the trace probe's dot products, on CUDA cores and on tensor cores
// (sm_90a).
//
// Replaces scripts/mxu_trace_probe.py (the pallas_call at :77 of body :37
// through kernel_vpu :65 and kernel_mxu :70), which asks whether the
// ray-primitive dot products of a trace belong on the matrix unit. Per
// pixel, 9 chained "bounce segments"; a segment takes the 54 dot products
// U_c = sum_f B[c, f] x_f of the pixel's 8 features with the rows of B
// (54, 8), sets acc = (acc + U0 U1 - U2) + U3 + ... + U53 and replaces
// feature 0 with acc * 1e-6. Inputs x (8, n) f32 planes, B (54, 8) f32;
// output acc (n,) f32.
//
// Two kernels, one per question:
//
// - cuda_core: one thread per pixel, B in __constant__ memory (every
//   thread reads the same B[c, f], so each is a broadcast constant
//   operand). It runs the VPU body's mul/add chains in its order (s =
//   B[c,0] x0, then s + B[c,f] x_f; acc + U0 U1 - U2, then + U_c in
//   order), so under --fmad=false it equals the plain version bit for
//   bit. Bound by FP32 operations: 9 * (54 * 15 + 55) = 7785 a pixel.
// - tensor_core: mma.sync.aligned.m16n8k8 with TF32 inputs and an f32
//   accumulator. A warp takes 16 pixels (M), K = the 8 features, and the
//   54 columns padded with zeros to 7 n-tiles of 8. Precision.HIGHEST is
//   near-f32, so each operand is split a = hi + lo (cvt.rna.tf32.f32
//   twice) and a product is hi*hi + hi*lo + lo*hi: three MMAs a tile
//   ("3xTF32"); one TF32 pass keeps about three digits. Fragment layout
//   (PTX ISA, m16n8k8 .tf32): g = lane >> 2, t = lane & 3; a0 (row g, k t),
//   a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4); b0 (k t, col g), b1 (t+4, g);
//   c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1). So feature 0
//   of pixels g and g+8 sits in a0/a1 of the t = 0 thread, and a pixel's
//   54 dot products are spread over the four threads of its quad: each
//   segment reduces U0, U1, U2 and the sum of U3..U53 across the quad
//   (shuffles; every thread of the quad ends with the same acc), and only
//   the t = 0 threads rewrite their feature-0 fragment. The sum of U3..U53
//   is taken in another order than the chain (per thread, then over the
//   quad), as the MXU body's jnp.sum is. Bound by the tensor core's TF32
//   rate (3 passes * 56 * 8 * 2 operations a pixel a segment).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NF = 8, NCOL = 54, REPEAT = 9;
constexpr int NTILE = (NCOL + 7) / 8;   // 7 n-tiles of 8 columns

__constant__ float c_B[NCOL * NF];

__device__ __forceinline__ float column_dot(const float (&f)[NF], int c) {
    float s = c_B[c * NF] * f[0];
#pragma unroll
    for (int k = 1; k < NF; ++k) s = s + c_B[c * NF + k] * f[k];
    return s;
}

__global__ void __launch_bounds__(256)
trace_dots_cuda_core(const float* __restrict__ x, float* __restrict__ out, int n) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n) return;
    float f[NF];
#pragma unroll
    for (int k = 0; k < NF; ++k) f[k] = x[(size_t)k * n + p];
    float acc = 0.0f;
#pragma unroll 1
    for (int rep = 0; rep < REPEAT; ++rep) {
        const float u0 = column_dot(f, 0), u1 = column_dot(f, 1), u2 = column_dot(f, 2);
        acc = acc + u0 * u1 - u2;
        // 51 = 3 * 17: unrolled whole, the scheduler hoists the 408
        // independent products (255 registers and spills); 17 at a time
        // keeps it at 32 registers
#pragma unroll 17
        for (int c = 3; c < NCOL; ++c) acc = acc + column_dot(f, c);
        f[0] = acc * 1e-6f;
    }
    out[p] = acc;
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
    return r;
}

// v = hi + lo, both TF32 (the 3xTF32 split)
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
    hi = to_tf32(v);
    lo = to_tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(128)
trace_dots_tensor_core(const float* __restrict__ x, const float* __restrict__ B,
                       float* __restrict__ out, int n) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int p0 = ((blockIdx.x * blockDim.x + threadIdx.x) >> 5) * 16;
    if (p0 >= n) return;                          // the whole warp leaves
    const int pa = p0 + g, pb = p0 + g + 8;       // this thread's two pixel rows
    const bool va = pa < n, vb = pb < n;
    const unsigned full = 0xffffffffu;

    float a[4];
    a[0] = va ? x[(size_t)t * n + pa] : 0.0f;
    a[1] = vb ? x[(size_t)t * n + pb] : 0.0f;
    a[2] = va ? x[(size_t)(t + 4) * n + pa] : 0.0f;
    a[3] = vb ? x[(size_t)(t + 4) * n + pb] : 0.0f;
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split(a[i], ahi[i], alo[i]);

    // B as the (K = 8) x (N = 56) col-major operand: b0 = B[col g][k t],
    // b1 = B[col g][k t+4]; the padded columns 54, 55 are zero
    uint32_t bhi[NTILE][2], blo[NTILE][2];
#pragma unroll
    for (int j = 0; j < NTILE; ++j) {
        const int col = 8 * j + g;
        const float b0 = col < NCOL ? B[col * NF + t] : 0.0f;
        const float b1 = col < NCOL ? B[col * NF + t + 4] : 0.0f;
        split(b0, bhi[j][0], blo[j][0]);
        split(b1, bhi[j][1], blo[j][1]);
    }

    const int quad = lane & ~3;
    float acc_a = 0.0f, acc_b = 0.0f;              // pixels pa and pb
#pragma unroll 1
    for (int rep = 0; rep < REPEAT; ++rep) {
        float d[NTILE][4];
#pragma unroll
        for (int j = 0; j < NTILE; ++j) {
            d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.0f;
            mma_tf32(d[j], alo, bhi[j][0], bhi[j][1]);
            mma_tf32(d[j], ahi, blo[j][0], blo[j][1]);
            mma_tf32(d[j], ahi, bhi[j][0], bhi[j][1]);
        }
        // this thread's share of U3..U53: columns 8j + 2t + e
        float sa = 0.0f, sb = 0.0f;
#pragma unroll
        for (int j = 0; j < NTILE; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int col = 8 * j + 2 * t + e;
                if (col >= 3 && col < NCOL) {
                    sa = sa + d[j][e];
                    sb = sb + d[j][2 + e];
                }
            }
        }
        sa = sa + __shfl_xor_sync(full, sa, 1);
        sa = sa + __shfl_xor_sync(full, sa, 2);
        sb = sb + __shfl_xor_sync(full, sb, 1);
        sb = sb + __shfl_xor_sync(full, sb, 2);
        // U0, U1 sit in the quad's t = 0 thread (c0, c1 / c2, c3), U2 in t = 1's c0 / c2
        const float u0a = __shfl_sync(full, d[0][0], quad);
        const float u1a = __shfl_sync(full, d[0][1], quad);
        const float u2a = __shfl_sync(full, d[0][0], quad | 1);
        const float u0b = __shfl_sync(full, d[0][2], quad);
        const float u1b = __shfl_sync(full, d[0][3], quad);
        const float u2b = __shfl_sync(full, d[0][2], quad | 1);
        acc_a = acc_a + u0a * u1a - u2a;
        acc_a = acc_a + sa;
        acc_b = acc_b + u0b * u1b - u2b;
        acc_b = acc_b + sb;
        if (t == 0) {                              // feature 0 of rows g, g+8
            split(va ? acc_a * 1e-6f : 0.0f, ahi[0], alo[0]);
            split(vb ? acc_b * 1e-6f : 0.0f, ahi[1], alo[1]);
        }
    }
    if (t == 0) {
        if (va) out[pa] = acc_a;
        if (vb) out[pb] = acc_b;
    }
}

}  // namespace

extern "C" int cprt_trace_dots(const float* x, const float* B, float* out, int n,
                               int tensor_core, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (tensor_core) {
        const int warps = (n + 15) / 16;
        trace_dots_tensor_core<<<(warps + 3) / 4, 128, 0, s>>>(x, B, out, n);
    } else {
        const cudaError_t err = cudaMemcpyToSymbolAsync(
            c_B, B, sizeof(float) * NCOL * NF, 0, cudaMemcpyDeviceToDevice, s);
        if (err != cudaSuccess) return (int)err;
        trace_dots_cuda_core<<<(n + 255) / 256, 256, 0, s>>>(x, out, n);
    }
    return (int)cudaGetLastError();
}

extern "C" const char* cprt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
