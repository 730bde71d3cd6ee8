// K7: a texel gather through the read-only path, from planes or from a
// packed RGBX table (sm_90a).
//
// Replaces scripts/gather_bench.py::pallas_tga (the pallas_call at :85 of
// _tga_kernel :70), the in-kernel take_along_axis that gathers texels of
// one (1, 256 * 512) f32 plane held in VMEM: out[p] = plane[flat[p]].
// On the H100 the 512 KB plane (or the 2 MB packed table) stays in the 50
// MB L2, so the gather needs no staging into shared memory: one thread per
// query reads its index and its texel with __ldg (the read-only, non-
// coherent path). Two layouts, one kernel each:
//
// - planar: a (planes, entries) f32 table, out (planes, n); planes = 1 is
//   pallas_tga, planes = 3 the three channel planes kernel E reads;
// - packed: an (entries, 4) f32 RGBX table, out (n, 4): one 16-byte load
//   and one 16-byte store per query (the packed table that PERF.md asks
//   about for kernel E).
//
// Indices are int32 and clamped to [0, entries). What bounds it: bytes,
// 4 of index and 4 (planar, per plane) or 16 (packed) of output per query
// and the table once; at 921600 queries that is 2-5 microseconds at the
// HBM rate, so the launch latency (a few microseconds) dominates.

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
gather_planar(const float* __restrict__ table, int entries, int planes,
              const int* __restrict__ idx, int n, float* __restrict__ out) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n) return;
    const int i = min(max(__ldg(idx + p), 0), entries - 1);
#pragma unroll 3
    for (int c = 0; c < planes; ++c)
        out[(size_t)c * n + p] = __ldg(table + (size_t)c * entries + i);
}

__global__ void __launch_bounds__(256)
gather_packed(const float4* __restrict__ table, int entries,
              const int* __restrict__ idx, int n, float4* __restrict__ out) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n) return;
    const int i = min(max(__ldg(idx + p), 0), entries - 1);
    out[p] = __ldg(table + i);
}

}  // namespace

extern "C" int cprt_texel_gather(const float* table, int entries, int planes,
                                 const int* idx, int n, float* out, void* stream) {
    const int threads = 256, blocks = (n + threads - 1) / threads;
    const cudaStream_t s = (cudaStream_t)stream;
    if (planes > 0)
        gather_planar<<<blocks, threads, 0, s>>>(table, entries, planes, idx, n, out);
    else
        gather_packed<<<blocks, threads, 0, s>>>(
            reinterpret_cast<const float4*>(table), entries, idx, n,
            reinterpret_cast<float4*>(out));
    return (int)cudaGetLastError();
}
