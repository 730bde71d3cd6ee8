// K8b: a gather from a table held in the distributed shared memory of a
// thread-block cluster (sm_90a).
//
// Replaces scripts/overlap_probe.py::p3_mosaic_vmem_gather (the
// pallas_call at :199), which asks whether a dynamic gather can read an
// env table that lives in on-chip memory: out = table.flat[rows * 512 +
// cols] over a (256, 512) f32 table, rows and columns int32 and clamped
// to the table. The table is 512 KB, more than one SM's 227 KB of shared
// memory, so a cluster of 4 blocks holds it: block rank r keeps rows 64 r
// .. 64 r + 63, 128 KB of dynamic shared memory. A query reads its texel
// from rank row / 64, local row row % 64, by mapa + ld.shared::cluster
// (DSMEM, the SM-to-SM network).
//
// - Staging: thread 0 issues the block's rows as TMA bulk copies
//   (cp.async.bulk, 32 KB a piece) on one mbarrier; while they land, every
//   thread loads the indices of its first queries. Then each thread waits
//   on the barrier, and cluster.sync() publishes the rows to the cluster.
// - Queries: 4 consecutive queries a thread and iteration: int4 loads of
//   rows and cols, 4 independent DSMEM reads, a float4 store; the
//   next iteration's indices load before this one's reads. Where rows,
//   cols and out share their offset modulo 16 bytes, a scalar head of up
//   to 3 queries aligns them; otherwise every query takes the scalar path.
//   A scalar tail takes what the 4-wide body leaves.
// - cluster.sync() again before exit, so no block leaves while a
//   neighbour reads its shared memory.
//
// Launched with cudaLaunchKernelEx and a cluster-dimension attribute, as
// many clusters as the queries need, up to the number resident at once
// (asked once, beside the shared-memory opt-in). Every cluster stages its
// own copy of the table, 512 KB a cluster.
//
// What bounds it: bytes, 8 of index and 4 of output a query and the table
// once, 3.5 us at 921600 queries. In practice the scattered remote reads:
// the same launch with every query at one texel takes 0.4 of the time,
// and on the H100 the gather loses to one through L2 (PERF.md, the K8b
// row). The launch shape is the fastest of those measured (PERF.md): a
// cluster of 4 (8 and 16, with less staging a SM, ran slower), 4 queries
// a thread (8 ran slower), 256 threads a block (larger blocks ran slower).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TH = 256, TW = 512, THREADS = 256, PIECE = 32 * 1024;
constexpr int CL = 4, ROWS = TH / CL;          // blocks a cluster, rows a block
constexpr int V = 4;                           // queries a thread and iteration
constexpr uint32_t PART = ROWS * TW * 4;       // bytes a block holds

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

// the texel at (row, col), clamped, from the cluster's shared memory;
// volatile keeps the read after the cluster barrier
__device__ __forceinline__ float texel(uint32_t base, int r, int c) {
    r = min(max(r, 0), TH - 1);
    c = min(max(c, 0), TW - 1);
    uint32_t remote;
    float v;
    asm("mapa.shared::cluster.u32 %0, %1, %2;\n"
        : "=r"(remote) : "r"(base + (uint32_t)(((r % ROWS) * TW + c) * 4)), "r"(r / ROWS));
    asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote));
    return v;
}

__global__ void __launch_bounds__(THREADS)
dsmem_gather_kernel(const float* __restrict__ table, const int* __restrict__ rows,
                    const int* __restrict__ cols, int n, int head, int nvec,
                    float* __restrict__ out) {
    extern __shared__ __align__(128) float part[];
    __shared__ __align__(8) uint64_t bar;
    cg::cluster_group cluster = cg::this_cluster();
    const uint32_t base = smem_addr(part), b = smem_addr(&bar);
    if (threadIdx.x == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(b) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     :: "r"(b), "r"(PART) : "memory");
        const char* src = reinterpret_cast<const char*>(table) + cluster.block_rank() * PART;
        for (uint32_t off = 0; off < PART; off += PIECE)
            asm volatile(
                "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                "[%0], [%1], %2, [%3];\n"
                :: "r"(base + off), "l"(src + off), "r"((uint32_t)PIECE), "r"(b) : "memory");
    }
    const int gid = blockIdx.x * THREADS + threadIdx.x, stride = gridDim.x * THREADS;
    const int4* rh = reinterpret_cast<const int4*>(rows + head);
    const int4* ch = reinterpret_cast<const int4*>(cols + head);
    float4* oh = reinterpret_cast<float4*>(out + head);
    int v = gid;
    int4 r = {}, c = {};
    if (v < nvec) {                               // while the rows land
        r = __ldg(rh + v);
        c = __ldg(ch + v);
    }
    __syncthreads();                              // the barrier's init, for the waits
    mbar_wait(b, 0);
    cluster.sync();

    for (int q = gid; q < head; q += stride) out[q] = texel(base, __ldg(rows + q), __ldg(cols + q));
    while (v < nvec) {
        const int next = v + stride;
        int4 nr = r, nc = c;
        if (next < nvec) {
            nr = __ldg(rh + next);
            nc = __ldg(ch + next);
        }
        oh[v] = make_float4(texel(base, r.x, c.x), texel(base, r.y, c.y),
                            texel(base, r.z, c.z), texel(base, r.w, c.w));
        r = nr;
        c = nc;
        v = next;
    }
    for (int q = head + nvec * V + gid; q < n; q += stride)
        out[q] = texel(base, __ldg(rows + q), __ldg(cols + q));
    cluster.sync();
}

}  // namespace

extern "C" int cprt_dsmem_gather(const float* table, const int* rows, const int* cols, int n,
                                 float* out, void* stream) {
    if (n < 0 || ((uintptr_t)table & 15) || ((uintptr_t)rows & 3) || ((uintptr_t)cols & 3)
        || ((uintptr_t)out & 3))
        return (int)cudaErrorInvalidValue;
    static int max_clusters = 0;   // asked once, beside the opt-in
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CL);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = PART;
    cfg.stream = (cudaStream_t)stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t err;
    if (max_clusters == 0) {
        err = cudaFuncSetAttribute(dsmem_gather_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, PART);
        if (err != cudaSuccess) return (int)err;
        err = cudaOccupancyMaxActiveClusters(&max_clusters, dsmem_gather_kernel, &cfg);
        if (err != cudaSuccess) return (int)err;
        if (max_clusters < 1) return (int)cudaErrorInvalidConfiguration;
    }
    // the split: a scalar head that aligns rows, cols and out to 16 bytes
    // (all of n where their offsets differ), the 4-wide body, a scalar tail
    const uintptr_t r = (uintptr_t)rows;
    const bool same = ((r ^ (uintptr_t)cols) & 15) == 0 && ((r ^ (uintptr_t)out) & 15) == 0;
    const int head = same ? min(n, (int)((16 - (r & 15)) & 15) / 4) : n;
    const int nvec = (n - head) / V;
    const long long per = (long long)CL * THREADS * V;
    const long long want = ((long long)n + per - 1) / per;
    cfg.gridDim = dim3(CL * (int)(want < max_clusters ? (want > 0 ? want : 1) : max_clusters));
    err = cudaLaunchKernelEx(&cfg, dsmem_gather_kernel, table, rows, cols, n, head, nvec, out);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
