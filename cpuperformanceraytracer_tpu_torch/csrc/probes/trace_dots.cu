// K6: the trace probe's dot products, on CUDA cores and on tensor cores,
// per warp (mma.sync) and per warpgroup (wgmma) (sm_90a).
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
// Three kernels, one per question:
//
// - cuda_core: one thread per pixel, B in __constant__ memory (every
//   thread reads the same B[c, f], so each is a broadcast constant
//   operand). It runs the VPU body's mul/add chains in its order (s =
//   B[c,0] x0, then s + B[c,f] x_f; acc + U0 U1 - U2, then + U_c in
//   order), so under --fmad=false it equals the plain version bit for
//   bit. Bound by FP32 operations: 9 * (54 * 15 + 55) = 7785 a pixel,
//   0.1071 ms at 720p over 67 TFLOP/s. That peak counts an FMA as two
//   operations; under --fmad=false (the parity policy) each mul and add
//   is an instruction of its own, so the bound this kernel can reach is
//   the SMs' issue rate, 132 SMs * 128 lanes * the clock: 7785 * 921600
//   instructions / 3.345e13 a second = 0.2145 ms at 1.98 GHz (clocks.sm
//   read under load: PERF.md, the K6 row).
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
//   rate (3 passes * 56 * 8 * 2 operations a pixel a segment). It stays
//   the answer for a kernel whose warps cannot gather into a warpgroup,
//   as a divergent path tracer's warps cannot.
// - wgmma (replaces kernel_mxu, mxu_trace_probe.py:70, on this card's
//   full-rate instruction): wgmma.mma_async.m64n56k8.f32.tf32.tf32, a
//   warpgroup (4 warps) per tile of 64 pixels (M), the 54 columns of B and
//   two zero columns (N = 56), K = the 8 features. Three wgmmas a segment
//   into one accumulator, in the tensor_core kernel's pass order (lo*hi with
//   scale-d = 0, so no register fills; hi*lo; hi*hi). A comes from
//   registers: each warp's fragment of its 16 rows has the m16n8k8 map above
//   (warp w of the group takes rows 16w..16w+15), so a segment re-splits
//   only feature 0, in the t = 0 threads. B comes from shared memory: its hi
//   and lo parts are split once a block and written as (56, 8) K-major tiles
//   in the no-swizzle core-matrix layout (core matrices of 8 rows x 16
//   bytes; LBO 128 bytes between the two along K, SBO 256 between the 7
//   along N), one 64-bit descriptor each. The accumulator, 28 f32 a thread,
//   has the per-tile map of mma.sync's c0..c3 (d[4j + i] at n-tile j), so
//   the tensor_core epilogue carries over, kept in the t = 0 lane of each
//   quad (U0, U1 its own, U2 one shuffle from t = 1, the quad sum the same
//   butterfly) with feature 0 re-split by the bit form of cvt.rna for finite
//   values: about 80 SASS instructions a warp a tile and segment. Bound: the
//   TF32 rate, 3 * 56 * 8 * 2 operations a pixel a segment (0.0450 ms at
//   720p over 495 TFLOP/s). On the H100 the wgmmas alone run near that rate,
//   the epilogue alone takes most of their time again, and together they
//   overlap only in part (PERF.md, K6). A tile is a dependent chain of 9 x
//   (3 wgmma + epilogue); a warpgroup keeps one tile in flight (its three
//   wgmmas committed as a group, wgmma.wait_group 0 before its epilogue),
//   and the other warpgroups of its block (WG_PER_BLOCK) and of the SM's
//   other blocks keep the tensor cores fed while it runs its epilogue.
//   Registers cap the chains an SM holds at 6-8 whatever the split: 1-3
//   tiles in flight a warpgroup with 1-3 warpgroups a block ran within a few
//   percent of each other, 4 tiles slower, and one tile x 3 warpgroups was
//   the fastest measured (PERF.md has every shape's time). A persistent grid
//   (one block a resident slot, the occupancy asked once) walks the tiles;
//   the next tile's x loads before the current tile's segments; a ragged
//   last tile reads zeros past n and stores nothing there. The segments are unrolled: a
//   loop-carried copy of an operand register inside a pipeline stage makes
//   ptxas serialise the wgmmas (C7513). The probe measures 54 x 8 products a
//   segment: only feature 0 changes between segments, so sum_{f>=1} B[c, f]
//   x_f could be taken once, but the kernel does all 9 x 54 x 8 products in
//   3 passes, or its time would answer another question.

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


// ---- wgmma: a warpgroup a tile of 64 pixels, one tile in flight ----

constexpr int WG_PER_BLOCK = 3;    // warpgroups a block
constexpr int TILE = 64;           // pixels a tile: wgmma's M
constexpr int NPAD = 8 * NTILE;    // wgmma's N: the 54 columns and 2 zero ones
constexpr int ND = NPAD / 2;       // accumulator registers a thread

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a K-major operand in shared memory, no swizzle: start address, LBO (the
// next core matrix along K) 128 bytes, SBO (the next 8 rows) 256 bytes
__device__ __forceinline__ uint64_t b_descriptor(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16)
           | ((uint64_t)(256 >> 4) << 32);
}

// where B's element (column c, feature k) sits in its (56, 8) tile, in floats
__device__ constexpr int b_offset(int c, int k) {
    return (c >> 3) * 64 + (k >> 2) * 32 + (c & 7) * 4 + (k & 3);
}

// keep the compiler from moving an operand's reads or writes across the
// wgmma fence, commit and wait (which name no registers)
__device__ __forceinline__ void fence_operands(float (&d)[ND]) {
#pragma unroll
    for (int i = 0; i < ND; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_operands(uint32_t (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

template <int SCALE_D>
__device__ __forceinline__ void wgmma_tf32(float (&d)[ND], const uint32_t (&a)[4],
                                           uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %33, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27}, "
        "{%28, %29, %30, %31}, %32, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
          "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
          "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
          "+f"(d[27])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(SCALE_D));
}

__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// a segment's three passes, committed as one group
__device__ __forceinline__ void issue_segment(float (&d)[ND], uint32_t (&ahi)[4],
                                              uint32_t (&alo)[4], uint64_t bhi,
                                              uint64_t blo) {
    fence_operands(ahi);
    fence_operands(alo);
    fence_operands(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    wgmma_tf32<0>(d, alo, bhi);
    wgmma_tf32<1>(d, ahi, blo);
    wgmma_tf32<1>(d, ahi, bhi);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    fence_operands(d);
}

// cvt.rna.tf32.f32 for a finite v: round the 13 low mantissa bits to
// nearest, ties away from zero (the instruction's emulation without its
// inf / NaN selects: an epilogue value is finite)
__device__ __forceinline__ uint32_t to_tf32_finite(float v) {
    return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// the tensor_core kernel's epilogue on one tile, kept in the t = 0 lane of
// each quad (which holds U0, U1 and feature 0 of both rows): U2 from the
// t = 1 lane, the quad's sum of U3..U53 over the same butterfly, acc, then
// feature 0 re-split (a select, so the warp stays converged for the next
// wgmma). The other lanes' acc is not used.
__device__ __forceinline__ void finish_segment(const float (&d)[ND], int t, float& acc_a,
                                               float& acc_b, uint32_t (&ahi)[4],
                                               uint32_t (&alo)[4]) {
    const unsigned full = 0xffffffffu;
    float sa = 0.0f, sb = 0.0f;
#pragma unroll
    for (int j = 0; j < NTILE; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + 2 * t + e;
            if (col >= 3 && col < NCOL) {
                sa = sa + d[4 * j + e];
                sb = sb + d[4 * j + 2 + e];
            }
        }
    }
    sa = sa + __shfl_xor_sync(full, sa, 1);
    sa = sa + __shfl_xor_sync(full, sa, 2);
    sb = sb + __shfl_xor_sync(full, sb, 1);
    sb = sb + __shfl_xor_sync(full, sb, 2);
    const float u2a = __shfl_down_sync(full, d[0], 1);
    const float u2b = __shfl_down_sync(full, d[2], 1);
    acc_a = acc_a + d[0] * d[1] - u2a;
    acc_a = acc_a + sa;
    acc_b = acc_b + d[2] * d[3] - u2b;
    acc_b = acc_b + sb;
    const float fa = acc_a * 1e-6f, fb = acc_b * 1e-6f;
    const uint32_t ha = to_tf32_finite(fa), hb = to_tf32_finite(fb);
    const uint32_t la = to_tf32_finite(fa - __uint_as_float(ha));
    const uint32_t lb = to_tf32_finite(fb - __uint_as_float(hb));
    ahi[0] = t == 0 ? ha : ahi[0];
    alo[0] = t == 0 ? la : alo[0];
    ahi[1] = t == 0 ? hb : ahi[1];
    alo[1] = t == 0 ? lb : alo[1];
}

// this thread's A fragment of tile `tile`: rows r and r + 8, features t, t + 4
__device__ __forceinline__ void load_fragment(const float* __restrict__ x, int n,
                                              int tile, int r, int t, float (&v)[4]) {
    const int pa = tile * TILE + r, pb = pa + 8;
    v[0] = pa < n ? __ldg(x + (size_t)t * n + pa) : 0.0f;
    v[1] = pb < n ? __ldg(x + (size_t)t * n + pb) : 0.0f;
    v[2] = pa < n ? __ldg(x + (size_t)(t + 4) * n + pa) : 0.0f;
    v[3] = pb < n ? __ldg(x + (size_t)(t + 4) * n + pb) : 0.0f;
}

__global__ void __launch_bounds__(128 * WG_PER_BLOCK)
trace_dots_wgmma(const float* __restrict__ x, const float* __restrict__ B,
                 float* __restrict__ out, int n) {
    __shared__ __align__(128) float sb[2][NPAD * NF];      // B's hi, lo tiles
    for (int i = threadIdx.x; i < NPAD * NF; i += blockDim.x) {
        const int c = i / NF, k = i % NF;
        uint32_t hi, lo;
        split(c < NCOL ? B[c * NF + k] : 0.0f, hi, lo);
        sb[0][b_offset(c, k)] = __uint_as_float(hi);
        sb[1][b_offset(c, k)] = __uint_as_float(lo);
    }
    // the generic-proxy writes, visible to the async proxy wgmma reads with
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint64_t bhi = b_descriptor(smem_addr(sb[0])), blo = b_descriptor(smem_addr(sb[1]));

    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    const int r = 16 * warp + g;                         // rows r and r + 8 of a tile
    const int tiles = (n + TILE - 1) / TILE;
    const int stride = gridDim.x * WG_PER_BLOCK;
    int tile = blockIdx.x * WG_PER_BLOCK + (threadIdx.x >> 7);

    float raw[4];
    load_fragment(x, n, tile, r, t, raw);
    for (; tile < tiles; tile += stride) {
        // every register a wgmma reads is defined here, before the first
        // fence, or by an epilogue after the wait: the segments are
        // unrolled, so no copy of a loop-carried register falls inside a
        // pipeline stage (ptxas serialises the wgmmas where one does)
        float d[ND], acc_a = 0.0f, acc_b = 0.0f;
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int i = 0; i < ND; ++i) d[i] = 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) split(raw[i], ahi[i], alo[i]);
        // the next tile's fragment loads while this tile's segments run
        load_fragment(x, n, tile + stride, r, t, raw);

        issue_segment(d, ahi, alo, bhi, blo);
#pragma unroll
        for (int seg = 1; seg < REPEAT; ++seg) {
            wgmma_wait_all();                            // segment seg - 1
            fence_operands(d);
            finish_segment(d, t, acc_a, acc_b, ahi, alo);
            issue_segment(d, ahi, alo, bhi, blo);
        }
        wgmma_wait_all();
        fence_operands(d);
        finish_segment(d, t, acc_a, acc_b, ahi, alo);
        const int pa = tile * TILE + r;
        if (t == 0) {
            if (pa < n) out[pa] = acc_a;
            if (pa + 8 < n) out[pa + 8] = acc_b;
        }
    }
}

// the grid: one block a resident slot (the occupancy asked once), at most
// one warpgroup a tile
int launch_wgmma(const float* x, const float* B, float* out, int n, cudaStream_t s) {
    static int slots = 0;
    if (slots == 0) {
        int dev, per_sm, sms;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, trace_dots_wgmma, 128 * WG_PER_BLOCK, 0);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return (int)err;
        if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
        slots = per_sm * sms;
    }
    const int tiles = (n + TILE - 1) / TILE;
    const int want = (tiles + WG_PER_BLOCK - 1) / WG_PER_BLOCK;
    trace_dots_wgmma<<<want < slots ? want : slots, 128 * WG_PER_BLOCK, 0, s>>>(x, B, out, n);
    return (int)cudaGetLastError();
}

}  // namespace

// unit: 0 cuda_core, 1 tensor_core (mma.sync), 2 wgmma
extern "C" int cprt_trace_dots(const float* x, const float* B, float* out, int n,
                               int unit, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (unit == 2) return launch_wgmma(x, B, out, n, s);
    if (unit == 1) {
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
