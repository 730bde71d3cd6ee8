// K8b: a gather from a table held in the distributed shared memory of a
// thread-block cluster (sm_90a).
//
// Replaces scripts/overlap_probe.py::p3_mosaic_vmem_gather (the
// pallas_call at :199), which asks whether a dynamic gather can read an
// env table that lives in on-chip memory: out = table.flat[rows * 512 +
// cols] over a (256, 512) f32 table. The table is 512 KB, more than one
// SM's 227 KB of shared memory, so a cluster of 4 blocks holds it: block
// rank r keeps rows 64 r .. 64 r + 63 (128 KB of dynamic shared memory,
// opted into with cudaFuncSetAttribute). Each block loads its rows,
// cluster.sync(); each query reads its texel from rank row / 64, local
// row row % 64, through cluster.map_shared_rank (DSMEM, the SM-to-SM
// network); cluster.sync() again before exit, so no block leaves while a
// neighbour reads its shared memory. Launched with cudaLaunchKernelEx and
// a cluster-dimension attribute, as many clusters as the queries need up
// to the number that fit on the card at once (each stages its own copy of
// the table); the clusters stride over the queries. Rows and columns are
// int32 and clamped to the table.
//
// What bounds it: at the probe's 2048 queries, the staging of 512 KB and
// the launch; at 921600 queries, bytes (8 of index and 4 of output a
// query) against the DSMEM read of one texel per query.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TH = 256, TW = 512, CLUSTER = 4, ROWS = TH / CLUSTER, THREADS = 1024;
constexpr int SMEM_BYTES = ROWS * TW * (int)sizeof(float);   // 128 KB a block

__global__ void __launch_bounds__(THREADS)
dsmem_gather_kernel(const float* __restrict__ table, const int* __restrict__ rows,
                    const int* __restrict__ cols, int n, float* __restrict__ out) {
    extern __shared__ float4 part4[];
    cg::cluster_group cluster = cg::this_cluster();
    const unsigned rank = cluster.block_rank();
    const float4* src = reinterpret_cast<const float4*>(table) + (size_t)rank * (ROWS * TW / 4);
    for (int i = threadIdx.x; i < ROWS * TW / 4; i += THREADS) part4[i] = __ldg(src + i);
    cluster.sync();
    float* part = reinterpret_cast<float*>(part4);
    const int stride = gridDim.x * THREADS;
    for (int q = blockIdx.x * THREADS + threadIdx.x; q < n; q += stride) {
        const int r = min(max(__ldg(rows + q), 0), TH - 1);
        const int c = min(max(__ldg(cols + q), 0), TW - 1);
        const float* remote = cluster.map_shared_rank(part, r / ROWS);
        out[q] = remote[(r % ROWS) * TW + c];
    }
    cluster.sync();
}

}  // namespace

extern "C" int cprt_dsmem_gather(const float* table, const int* rows, const int* cols, int n,
                                 float* out, void* stream) {
    static int max_clusters = 0;   // clusters resident at once, asked once
    cudaError_t err = cudaFuncSetAttribute(
        dsmem_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CLUSTER);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = SMEM_BYTES;
    cfg.stream = (cudaStream_t)stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (max_clusters == 0) {
        err = cudaOccupancyMaxActiveClusters(&max_clusters, dsmem_gather_kernel, &cfg);
        if (err != cudaSuccess) return (int)err;
        if (max_clusters < 1) return (int)cudaErrorInvalidConfiguration;
    }
    const int want = (n + CLUSTER * THREADS - 1) / (CLUSTER * THREADS);
    cfg.gridDim = dim3(CLUSTER * (want < max_clusters ? (want > 0 ? want : 1) : max_clusters));
    err = cudaLaunchKernelEx(&cfg, dsmem_gather_kernel, table, rows, cols, n, out);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
