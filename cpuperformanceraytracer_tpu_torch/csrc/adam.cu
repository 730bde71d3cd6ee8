// Adam: one step of torch.optim.Adam(capturable=True) over every trained
// leaf (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's update is optax.adam, which
// XLA fuses inside the training step's lax.scan. On the card the step ran
// torch's capturable foreach chain instead, about 17 kernels a step (the
// moments, the bias corrections on the 0-dim step tensors, the
// denominator, the update). This kernel does what that chain does, with
// the same float32 arithmetic, element by element:
//
//   t         = step + 1                          (adam_steps_kernel)
//   g         = maximize ? -grad : grad;  g = g + wd * p    (wd != 0)
//   m         = lerp(m, g, 1 - beta1)             (torch's two-sided lerp)
//   v         = v * beta2;  v = v + (1 - beta2) * (g * g)
//   step_size = 1 / ((beta1^t - 1) * (1 / lr))     (1 / lr taken in double)
//   bc2       = sqrt(-(beta2^t - 1))
//   d         = ((sqrt(v) / bc2) + eps) / step_size
//   p         = p + m / d
//
// torch's own kernels are built with FMA contraction, this library with
// --fmad=false: __fmaf_rn stands where torch's compiled kernel contracts a
// multiply-add (the lerp, the second moment's addcmul and the weight
// decay's add; found on the card, op by op), and torch's foreach division
// by a python scalar is a multiply by its reciprocal, so the bits are
// torch's.
//
// What bounds it: memory traffic, 28 bytes an element (p, g, m and v read;
// p, m and v written); a few dozen instructions an element are far under
// that. One launch covers every leaf: the table of leaves travels by value
// in the kernel's parameters, and a persistent grid, sized from the SM
// count, strides over the leaves' concatenated 16-byte vectors, then over
// their heads and tails (the values before and after each leaf's aligned
// bulk), one value at a time. Loads and stores keep the default caching,
// so that at 720p the 11 MB stay in L2 for kernel A's next read. A block
// computes each leaf's bias corrections once, from the leaf's device step.
// The steps advance in a tiny kernel launched first on the same stream, so
// no block of the update can read a step another block has advanced.
// Neither kernel allocates or synchronises: both can be captured into a
// CUDA graph.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEAVES = 32;  // kernels/adam.py's MAX_LEAVES
constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 4;

struct Leaf {
    float* p;
    const float* g;
    float* m;
    float* v;
    float* step;
    long long head;    // values before the 16-byte aligned bulk
    long long vec;     // float4 vectors of the bulk
    long long tail;    // values after it
    long long vstart;  // the leaf's first vector in the leaves' concatenated vectors
    long long sstart;  // its first head or tail value in their concatenated values
};

struct Table {
    Leaf leaf[MAX_LEAVES];
    int n;
};

struct Hyper {
    float inv_lr, beta1, beta2, w1, c2, eps, wd;
    int maximize;
};

__device__ __forceinline__ float adam_one(float p, float g, float& m, float& v,
                                          const Hyper& h, float step_size, float bc2) {
    if (h.maximize) g = -g;
    if (h.wd != 0.0f) g = __fmaf_rn(h.wd, p, g);
    // at::native::lerp: the small-weight side from m, the other from g
    const float diff = g - m;
    m = fabsf(h.w1) < 0.5f ? __fmaf_rn(h.w1, diff, m) : __fmaf_rn(-diff, 1.0f - h.w1, g);
    v = v * h.beta2;
    v = __fmaf_rn(h.c2, g * g, v);
    const float d = (sqrtf(v) / bc2 + h.eps) / step_size;
    return p + m / d;
}

__device__ __forceinline__ void adam_vec(const Leaf& leaf, long long j, const Hyper& h,
                                         float s, float b) {
    float4 p = reinterpret_cast<const float4*>(leaf.p + leaf.head)[j];
    const float4 g = __ldg(reinterpret_cast<const float4*>(leaf.g + leaf.head) + j);
    float4 m = reinterpret_cast<const float4*>(leaf.m + leaf.head)[j];
    float4 v = reinterpret_cast<const float4*>(leaf.v + leaf.head)[j];
    p.x = adam_one(p.x, g.x, m.x, v.x, h, s, b);
    p.y = adam_one(p.y, g.y, m.y, v.y, h, s, b);
    p.z = adam_one(p.z, g.z, m.z, v.z, h, s, b);
    p.w = adam_one(p.w, g.w, m.w, v.w, h, s, b);
    reinterpret_cast<float4*>(leaf.p + leaf.head)[j] = p;
    reinterpret_cast<float4*>(leaf.m + leaf.head)[j] = m;
    reinterpret_cast<float4*>(leaf.v + leaf.head)[j] = v;
}

// a thread's first index of a leaf's part that starts at ``start`` in a
// concatenated space the grid strides over: start + j = tid (mod stride)
__device__ __forceinline__ long long first(long long tid, long long start, long long stride) {
    return (tid - start % stride + stride) % stride;
}

__global__ void adam_steps_kernel(const __grid_constant__ Table table) {
    if (threadIdx.x < table.n) *table.leaf[threadIdx.x].step += 1.0f;
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
adam_kernel(const __grid_constant__ Table table, const Hyper h) {
    __shared__ float step_size[MAX_LEAVES];
    __shared__ float bc2[MAX_LEAVES];
    if (threadIdx.x < table.n) {
        const float t = *table.leaf[threadIdx.x].step;
        step_size[threadIdx.x] = 1.0f / ((powf(h.beta1, t) - 1.0f) * h.inv_lr);
        bc2[threadIdx.x] = sqrtf(-(powf(h.beta2, t) - 1.0f));
    }
    __syncthreads();
    const long long stride = (long long)gridDim.x * THREADS;
    const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
    for (int l = 0; l < table.n; ++l) {
        const Leaf& leaf = table.leaf[l];
        const float s = step_size[l], b = bc2[l];
        // the bulk in 16-byte vectors, then the head and the tail one
        // value at a time
        for (long long j = first(tid, leaf.vstart, stride); j < leaf.vec; j += stride)
            adam_vec(leaf, j, h, s, b);
        for (long long k = first(tid, leaf.sstart, stride); k < leaf.head + leaf.tail; k += stride) {
            const long long i = k < leaf.head ? k : k + 4 * leaf.vec;
            float m = leaf.m[i], v = leaf.v[i];
            leaf.p[i] = adam_one(leaf.p[i], leaf.g[i], m, v, h, s, b);
            leaf.m[i] = m;
            leaf.v[i] = v;
        }
    }
}

}  // namespace

extern "C" int cprt_adam(const long long* leaves, int n, float inv_lr, float beta1, float beta2,
                         float w1, float c2, float eps, float wd, int maximize, void* stream) {
    if (n <= 0) return 0;
    if (n > MAX_LEAVES) return (int)cudaErrorInvalidValue;
    Table table{};
    table.n = n;
    long long vectors = 0, values = 0;
    for (int l = 0; l < n; ++l) {
        const long long* row = leaves + 6 * l;
        Leaf& leaf = table.leaf[l];
        leaf.p = (float*)row[0];
        leaf.g = (const float*)row[1];
        leaf.m = (float*)row[2];
        leaf.v = (float*)row[3];
        leaf.step = (float*)row[4];
        const long long count = row[5];
        const uintptr_t a = (uintptr_t)leaf.p % 16;
        const bool together = (uintptr_t)leaf.g % 16 == a && (uintptr_t)leaf.m % 16 == a &&
                              (uintptr_t)leaf.v % 16 == a;
        if (together) {
            const long long head = (long long)((16 - a) % 16 / 4);
            leaf.head = head < count ? head : count;
            leaf.vec = (count - leaf.head) / 4;
        } else {
            leaf.head = count;
            leaf.vec = 0;
        }
        leaf.tail = count - leaf.head - 4 * leaf.vec;
        leaf.vstart = vectors;
        leaf.sstart = values;
        vectors += leaf.vec;
        values += leaf.head + leaf.tail;
    }
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    const long long units = vectors > values ? vectors : values;
    const long long want = (units + THREADS - 1) / THREADS;
    const long long most = (long long)sms * BLOCKS_PER_SM;
    const int blocks = (int)(want < 1 ? 1 : want < most ? want : most);
    const cudaStream_t s = (cudaStream_t)stream;
    adam_steps_kernel<<<1, MAX_LEAVES, 0, s>>>(table);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const Hyper h{inv_lr, beta1, beta2, w1, c2, eps, wd, maximize};
    adam_kernel<<<blocks, THREADS, 0, s>>>(table, h);
    return (int)cudaGetLastError();
}
