// K8a: serial row copies from device memory into shared memory, by TMA
// bulk copy or by cp.async (sm_90a).
//
// Replaces scripts/overlap_probe.py::p2_dma_descriptor_cost (the
// pallas_call at :159), which asks what one scalar-indexed async copy of a
// table row costs: for i < n, row idx[i] of an HBM table is copied into
// slot i % 8 of an on-chip (8, row) buffer, one copy at a time (started,
// then waited), and the buffer is written out. Contract: out[s] =
// table[idx[max{i < n : i % 8 == s}]], and 0 where no i < n has i % 8 ==
// s. Indices are clamped to the table.
//
// One block. Its threads first stage a chunk of indices in shared memory
// (the TPU kernel read them from SMEM); then one agent copies the rows of
// the chunk in order, each copy waited before the next starts:
//
// - tma: thread 0 issues cp.async.bulk.shared::cluster.global (the Tensor
//   Memory Accelerator's 1-D bulk copy, the counterpart of
//   pltpu.make_async_copy) with completion on an mbarrier that also
//   counts the bytes (mbarrier.arrive.expect_tx), and waits on the
//   barrier's phase. Any row of a multiple of 16 bytes: the probe's
//   512-byte row and the real 16-byte texel row (which the TPU could not
//   lower).
// - cp_async: warp 0, 16 bytes a lane (cp.async.cg), then cp.async.wait_all
//   and a warp barrier: the pre-Hopper asynchronous copy.
//
// What bounds it: the latency of one copy (issue, device memory or L2,
// completion); the bytes are a few KB. Report ns per copy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SLOTS = 8, MAX_ROW = 128, CHUNK = 2048, THREADS = 128;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
    uint32_t done;
    do {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done) : "r"(bar), "r"(phase) : "memory");
    } while (!done);
}

__global__ void __launch_bounds__(THREADS)
row_copy_kernel(const float* __restrict__ table, int rows, int row_floats,
                const int* __restrict__ idx, int n, float* __restrict__ out, int tma) {
    __shared__ __align__(128) float buf[SLOTS * MAX_ROW];
    __shared__ __align__(8) uint64_t bar;
    __shared__ int sidx[CHUNK];
    const int tid = threadIdx.x;
    const uint32_t row_bytes = (uint32_t)row_floats * 4u;

    for (int i = tid; i < SLOTS * MAX_ROW; i += THREADS) buf[i] = 0.0f;
    if (tid == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(&bar)) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // the zeros were written by the generic proxy; the bulk copies write
    // through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    uint32_t phase = 0;
    for (int base = 0; base < n; base += CHUNK) {
        const int m = min(CHUNK, n - base);
        for (int i = tid; i < m; i += THREADS) sidx[i] = min(max(idx[base + i], 0), rows - 1);
        __syncthreads();
        if (tma) {
            if (tid == 0) {
                const uint32_t b = smem_addr(&bar);
                for (int i = 0; i < m; ++i) {
                    const float* src = table + (size_t)sidx[i] * row_floats;
                    const uint32_t dst = smem_addr(buf + ((base + i) % SLOTS) * row_floats);
                    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                                 :: "r"(b), "r"(row_bytes) : "memory");
                    asm volatile(
                        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                        "[%0], [%1], %2, [%3];\n"
                        :: "r"(dst), "l"(src), "r"(row_bytes), "r"(b) : "memory");
                    mbar_wait(b, phase);
                    phase ^= 1u;
                }
            }
        } else if (tid < 32) {
            for (int i = 0; i < m; ++i) {
                const float* src = table + (size_t)sidx[i] * row_floats;
                float* dst = buf + ((base + i) % SLOTS) * row_floats;
                if (tid * 4 < row_floats)
                    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                                 :: "r"(smem_addr(dst + tid * 4)), "l"(src + tid * 4) : "memory");
                asm volatile("cp.async.wait_all;\n" ::: "memory");
                __syncwarp();
            }
        }
        __syncthreads();
    }
    for (int i = tid; i < SLOTS * row_floats; i += THREADS) out[i] = buf[i];
}

}  // namespace

extern "C" int cprt_row_copy(const float* table, int rows, int row_floats, const int* idx,
                             int n, float* out, int tma, void* stream) {
    if (row_floats <= 0 || row_floats > MAX_ROW || row_floats % 4) return (int)cudaErrorInvalidValue;
    row_copy_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(table, rows, row_floats, idx, n,
                                                              out, tma);
    return (int)cudaGetLastError();
}
