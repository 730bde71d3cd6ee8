// K8a: row copies from device memory into shared memory, by TMA bulk copy
// or by cp.async, with up to 8 copies in flight (sm_90a).
//
// Replaces scripts/overlap_probe.py::p2_dma_descriptor_cost (the
// pallas_call at :159), which asks what one scalar-indexed async copy of a
// table row costs: for i < n, row idx[i] of an HBM table is copied into
// slot i % 8 of an on-chip (8, row) buffer, and the buffer is written out.
// Contract: out[s] = table[idx[max{i < n : i % 8 == s}]], and 0 where no
// i < n has i % 8 == s. Indices are clamped to the table. All n copies are
// made: that work is what the probe measures.
//
// The TPU script started each copy and waited for it. Here up to `depth`
// (d, 1..8) copies are in flight: copy i is issued once copy i - d has
// completed, and once copy i - 8, the slot's previous copy, has completed,
// so two copies into one slot are never in flight together and the last
// copy into a slot lands last. d = 1 is the serial protocol, the latency
// of one copy.
//
// d issuer warps: warp k issues copies k, k + d, k + 2d, ..., each after
// its own previous one (copy i - d) has completed, and, where d does not
// divide 8, after the slot's previous copy (another warp's) too. One
// thread cannot keep the copies in flight: issuing a bulk copy takes a
// thread a good part of one copy's latency, so a single issuer's time a
// copy stops falling after depth 2. TMA completion goes to a ring of M =
// lcm(8, d) mbarriers (one a slot where d divides 8), copy i on barrier i %
// M, phase parity (i / M) & 1: a barrier moves on to copy i + M only after
// copy i + M - d and copy i + M - 8 have completed, both chains through
// copy i, so no wait can see a phase too late. Only lane 0 of a TMA
// issuer runs the loop.
//
// One block: warps 0-7 issue, warps 8-11 stage the indices in shared
// memory, clamped, in chunks of 4096 (16 KB), double-buffered: chunk c + 1
// is staged while the copies of chunk c are issued, and the copies in
// flight stay in flight across the block barrier between chunks.
//
// - tma: lane 0 of an issuer warp issues cp.async.bulk.shared::cluster.
//   global (the Tensor Memory Accelerator's 1-D bulk copy, the
//   counterpart of pltpu.make_async_copy) with completion on the copy's
//   mbarrier, which also counts the bytes (mbarrier.arrive.expect_tx). Any
//   row of a multiple of 16 bytes: the probe's 512-byte row and the real
//   16-byte texel row (which the TPU could not lower).
// - cp_async: the issuer warp, 16 bytes a lane (cp.async.cg, the
//   pre-Hopper asynchronous copy); its own previous copy is waited with
//   cp.async.wait_all and a warp barrier. Where d does not divide 8, each
//   copying lane also arrives on the copy's mbarrier when its piece has
//   landed (cp.async.mbarrier.arrive.noinc; the barrier counts row / 16
//   lanes), for the other warp's slot wait.
//
// What bounds it: the latency of a copy over the copies in flight, n t1 /
// d with t1 the time of one copy alone; the bytes (4096 x 512 B) take
// 0.6 us at the HBM rate. Report ns per copy at each depth.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SLOTS = 8, MAX_ROW = 128, CHUNK = 4096, ISSUERS = 8, STAGERS = 4,
              THREADS = 32 * (ISSUERS + STAGERS), MAX_BARS = 56;   // lcm(8, 7)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

__device__ __forceinline__ void stage(int* dst, const int* __restrict__ idx, int base, int n,
                                      int rows, int t, int nt) {
    const int m = min(CHUNK, n - base);
    for (int i = t; i < m; i += nt) dst[i] = min(max(idx[base + i], 0), rows - 1);
}

// TMA: bulk copies, else cp.async. The issuers' loop is the probe's
// critical path, one round trip a copy at depth 1: it keeps no branch on
// the mechanism and no integer division, which lengthened each round trip
// by more than half, and it reads a copy's index and forms its addresses
// before it waits for the previous copy (which took a tenth off a copy at
// depth 1).
template <bool TMA>
__global__ void __launch_bounds__(THREADS)
row_copy_kernel(const float* __restrict__ table, int rows, int row_floats,
                const int* __restrict__ idx, int n, float* __restrict__ out, int depth,
                int nbars) {
    __shared__ __align__(128) float buf[SLOTS * MAX_ROW];
    __shared__ __align__(8) uint64_t bar[MAX_BARS];
    __shared__ int sidx[2][CHUNK];
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int lanes = row_floats / 4;            // 16-byte pieces a row
    const uint32_t row_bytes = (uint32_t)row_floats * 4u;
    const bool slot_wait = SLOTS % depth != 0;   // copy g - 8 is another warp's

    for (int i = tid; i < SLOTS * MAX_ROW; i += THREADS) buf[i] = 0.0f;
    if (tid == 0) {
        for (int b = 0; b < nbars; ++b)
            asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                         :: "r"(smem_addr(bar + b)), "r"(TMA ? 1 : lanes) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if (n > 0) stage(sidx[0], idx, 0, n, rows, tid, THREADS);
    // the zeros were written by the generic proxy; the bulk copies write
    // through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // an issuer's next copy g, its barrier b = g % nbars and parity
    // (g / nbars) & 1, and its previous copy's (pb < 0: none yet)
    int g = warp, b = warp, pb = -1;
    uint32_t par = 0, ppar = 0;
    for (int base = 0, c = 0; base < n; base += CHUNK, c ^= 1) {
        const int* cur = sidx[c];
        const int end = min(base + CHUNK, n);
        if (warp >= ISSUERS) {
            if (base + CHUNK < n)
                stage(sidx[c ^ 1], idx, base + CHUNK, n, rows, tid - 32 * ISSUERS,
                      32 * STAGERS);
        } else if (warp < depth && (lane == 0 || !TMA)) {
            for (; g < end; g += depth) {
                // the addresses first, off the round trip: a cp.async lane
                // copies the row's 16 bytes at lane * 16. The empty asm
                // takes them, so the compiler forms them here, not after
                // the waits, where the index's shared-memory load and the
                // arithmetic would lengthen every round trip
                const int piece = TMA || lane >= lanes ? 0 : lane * 4;
                const float* src = table + (size_t)cur[g - base] * row_floats + piece;
                uint32_t dst = smem_addr(buf + (b % SLOTS) * row_floats + piece),
                         bb = smem_addr(bar + b);                     // slot g % 8
                asm volatile("" : "+r"(dst), "+r"(bb), "+l"(src));
                if (pb >= 0) {                                        // copy g - d
                    if (TMA) {
                        mbar_wait(smem_addr(bar + pb), ppar);
                    } else {
                        asm volatile("cp.async.wait_all;\n" ::: "memory");
                        __syncwarp();
                    }
                }
                if (slot_wait && g >= SLOTS)                          // copy g - 8
                    mbar_wait(smem_addr(bar + (b >= SLOTS ? b : b + nbars) - SLOTS),
                              b >= SLOTS ? par : par ^ 1u);
                if (TMA) {
                    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                                 :: "r"(bb), "r"(row_bytes) : "memory");
                    asm volatile(
                        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                        "[%0], [%1], %2, [%3];\n"
                        :: "r"(dst), "l"(src), "r"(row_bytes), "r"(bb) : "memory");
                } else if (lane < lanes) {
                    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                                 :: "r"(dst), "l"(src) : "memory");
                    if (slot_wait)
                        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                                     :: "r"(bb) : "memory");
                }
                pb = b;
                ppar = par;
                b += depth;
                if (b >= nbars) {
                    b -= nbars;
                    par ^= 1u;
                }
            }
        }
        __syncthreads();
    }
    // each issuer's last copy; the earlier ones were waited before its next
    if (warp < depth && pb >= 0) {
        if (TMA && lane == 0) mbar_wait(smem_addr(bar + pb), ppar);
        if (!TMA) asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
    __syncthreads();
    for (int i = tid; i < SLOTS * row_floats; i += THREADS) out[i] = buf[i];
}

}  // namespace

extern "C" int cprt_row_copy(const float* table, int rows, int row_floats, const int* idx,
                             int n, float* out, int tma, int depth, void* stream) {
    if (row_floats <= 0 || row_floats > MAX_ROW || row_floats % 4 || rows < 1 || n < 0
        || depth < 1 || depth > ISSUERS)
        return (int)cudaErrorInvalidValue;
    int nbars = SLOTS;                             // lcm(8, depth)
    while (nbars % depth) nbars += SLOTS;
    const cudaStream_t s = (cudaStream_t)stream;
    if (tma)
        row_copy_kernel<true><<<1, THREADS, 0, s>>>(table, rows, row_floats, idx, n, out, depth,
                                                   nbars);
    else
        row_copy_kernel<false><<<1, THREADS, 0, s>>>(table, rows, row_floats, idx, n, out, depth,
                                                    nbars);
    return (int)cudaGetLastError();
}
