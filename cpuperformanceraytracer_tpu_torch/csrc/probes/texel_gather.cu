// K7: a texel gather through the read-only path, from planes or from a
// packed RGBX table (sm_90a).
//
// Replaces scripts/gather_bench.py::pallas_tga (the pallas_call at :85 of
// _tga_kernel :70), the in-kernel take_along_axis that gathers texels of
// one (1, 256 * 512) f32 plane held in VMEM: out[p] = plane[flat[p]].
// Two layouts, one kernel each:
//
// - planar: a (planes, entries) f32 table, out (planes, n); planes = 1 is
//   pallas_tga, planes = 3 the three channel planes kernel E reads;
// - packed: an (entries, 4) f32 RGBX table, out (n, 4): one 16-byte load
//   and one 16-byte store a query (the packed table that PERF.md asks
//   about for kernel E).
//
// Indices are int32 and clamped to [0, entries). What bounds it: bytes,
// 4 of index and 4 (planar, per plane) or 16 (packed) of output a query
// and the table once, 2.4 us for one plane at 921600 queries. Beside that
// bound, each random 4-byte read moves a 32-byte L2 sector to the SM (29.5
// MB for one plane at 921600 queries).
//
// The design keeps many independent reads in flight and the indices and
// the output out of L1:
// - planar: a thread takes 4 consecutive queries: one 16-byte index load
//   that does not allocate in L1 (ld.global.nc.L1::no_allocate.v4), then
//   4 independent table loads per plane through L1 (ld.global.nc), all
//   planes' loads of a pass before its stores (12 in flight for three
//   planes), and one 16-byte streaming store per plane (st.global.cs.v4);
//   a view of the indices that does not start on 16 bytes takes a scalar
//   head of up to 3 queries, and what the 4-wide body leaves a scalar
//   tail (the wrapper allocates out at the indices' offset modulo 16
//   bytes, so the head aligns both); a plane c >= 1 that starts off 16
//   bytes (c * n not a multiple of 4) is stored 4 bytes at a time;
// - packed: a warp takes 128 queries, lane l the queries l, l + 32, l +
//   64 and l + 96: 4 index loads (no L1), 4 float4 table loads, 4 float4
//   streaming stores, each store of the warp on 512 contiguous bytes (4
//   consecutive queries a lane wrote half of each 32-byte sector a store
//   touched, and ran slower);
// - as many blocks as the chunks need, one chunk a thread (a warp for
//   packed): one wave of resident blocks walking the chunks with a grid
//   stride, the next chunk's indices loaded ahead, ran slower, and the
//   preferred L1 carveout changes nothing, so the default stays (PERF.md,
//   K7, has both times).
// On the H100 the gather stays bound by its scattered reads (PERF.md,
// K7): with every query at one texel it takes about a third of the time,
// and one query a thread with plain loads runs as fast or a little faster.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int V = 4;           // queries a thread and iteration
constexpr int MAX_PASS = 4;    // planes a pass of the planar kernel

__device__ __forceinline__ int4 load_indices(const int* p) {
    int4 v;
    asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
    return v;
}

__device__ __forceinline__ int load_index(const int* p) {
    int v;
    asm("ld.global.nc.L1::no_allocate.s32 %0, [%1];" : "=r"(v) : "l"(p));
    return v;
}

__device__ __forceinline__ int clamp_index(int i, int entries) {
    return min(max(i, 0), entries - 1);
}

__device__ __forceinline__ int4 clamp_indices(int4 i, int entries) {
    return make_int4(clamp_index(i.x, entries), clamp_index(i.y, entries),
                     clamp_index(i.z, entries), clamp_index(i.w, entries));
}

// P planes a pass; planes > MAX_PASS take several passes, the last one
// masked (the mask is the same in every thread)
template <int P>
__global__ void __launch_bounds__(THREADS)
gather_planar(const float* __restrict__ table, int entries, int planes,
              const int* __restrict__ idx, int n, int head, int nvec,
              float* __restrict__ out) {
    const int gid = blockIdx.x * THREADS + threadIdx.x, stride = gridDim.x * THREADS;
    for (int q = gid; q < head; q += stride) {
        const int i = clamp_index(load_index(idx + q), entries);
        for (int c = 0; c < planes; ++c)
            __stcs(out + (size_t)c * n + q, __ldg(table + (size_t)c * entries + i));
    }
    if (gid < nvec) {
        const int4 i = clamp_indices(load_indices(idx + head + V * gid), entries);
        const int q = head + V * gid;
        for (int c0 = 0; c0 < planes; c0 += P) {
            float4 t[P];
#pragma unroll
            for (int k = 0; k < P; ++k) {
                if (P == 1 || c0 + k < planes) {
                    const float* tb = table + (size_t)(c0 + k) * entries;
                    t[k] = make_float4(__ldg(tb + i.x), __ldg(tb + i.y), __ldg(tb + i.z),
                                       __ldg(tb + i.w));
                }
            }
#pragma unroll
            for (int k = 0; k < P; ++k) {
                if (P == 1 || c0 + k < planes) {
                    const int c = c0 + k;
                    float* o = out + (size_t)c * n + q;
                    if (((size_t)c * n & 3) == 0) {
                        __stcs(reinterpret_cast<float4*>(o), t[k]);
                    } else {
                        __stcs(o, t[k].x);
                        __stcs(o + 1, t[k].y);
                        __stcs(o + 2, t[k].z);
                        __stcs(o + 3, t[k].w);
                    }
                }
            }
        }
    }
    for (int q = head + V * nvec + gid; q < n; q += stride) {
        const int i = clamp_index(load_index(idx + q), entries);
        for (int c = 0; c < planes; ++c)
            __stcs(out + (size_t)c * n + q, __ldg(table + (size_t)c * entries + i));
    }
}

// a warp takes chunks of 32 * V queries, lane l the queries l, l + 32,
// l + 64 and l + 96 of a chunk: each float4 store of the warp writes 512
// contiguous bytes, where 4 consecutive queries a lane left each store
// half of each 32-byte sector it touched
__global__ void __launch_bounds__(THREADS)
gather_packed(const float4* __restrict__ table, int entries,
              const int* __restrict__ idx, int n, float4* __restrict__ out) {
    const int q0 = ((blockIdx.x * THREADS + threadIdx.x) >> 5) * 32 * V + (threadIdx.x & 31);
    int i[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
        const int q = q0 + 32 * k;
        i[k] = q < n ? clamp_index(load_index(idx + q), entries) : 0;
    }
    float4 t[V];
#pragma unroll
    for (int k = 0; k < V; ++k) t[k] = __ldg(table + i[k]);
#pragma unroll
    for (int k = 0; k < V; ++k)
        if (q0 + 32 * k < n) __stcs(out + q0 + 32 * k, t[k]);
}

template <int P>
int launch_planar(const float* table, int entries, int planes, const int* idx, int n,
                  int head, int nvec, float* out, cudaStream_t s) {
    const int threads = max(max(nvec, head), 1);
    gather_planar<P><<<(threads + THREADS - 1) / THREADS, THREADS, 0, s>>>(
        table, entries, planes, idx, n, head, nvec, out);
    return (int)cudaGetLastError();
}

}  // namespace

// planes 0: a packed (entries, 4) table, out (n, 4); else (planes,
// entries) planes, out (planes, n)
extern "C" int cprt_texel_gather(const float* table, int entries, int planes,
                                 const int* idx, int n, float* out, void* stream) {
    if (n < 0 || entries < 1 || planes < 0 || ((uintptr_t)table & 15)
        || ((uintptr_t)idx & 3) || ((uintptr_t)out & (planes ? 3 : 15)))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    if (planes == 0) {
        const int warps = max((n + 32 * V - 1) / (32 * V), 1);
        gather_packed<<<(warps * 32 + THREADS - 1) / THREADS, THREADS, 0, s>>>(
            reinterpret_cast<const float4*>(table), entries, idx, n,
            reinterpret_cast<float4*>(out));
        return (int)cudaGetLastError();
    }
    // the split: a scalar head that aligns the indices and out (allocated
    // at their offset modulo 16) to 16 bytes, the 4-wide body, a scalar
    // tail; an out at another offset takes the scalar path
    const uintptr_t i = (uintptr_t)idx;
    const int head = ((i ^ (uintptr_t)out) & 15) == 0
                         ? min(n, (int)((16 - (i & 15)) & 15) / 4) : n;
    const int nvec = (n - head) / V;
    switch (planes < MAX_PASS ? planes : MAX_PASS) {
        case 1: return launch_planar<1>(table, entries, planes, idx, n, head, nvec, out, s);
        case 2: return launch_planar<2>(table, entries, planes, idx, n, head, nvec, out, s);
        case 3: return launch_planar<3>(table, entries, planes, idx, n, head, nvec, out, s);
        default: return launch_planar<4>(table, entries, planes, idx, n, head, nvec, out, s);
    }
}
