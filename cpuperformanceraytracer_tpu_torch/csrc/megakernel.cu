// Kernel A: forward path-tracing megakernel for Hopper (sm_90a).
//
// Replaces cpuperformanceraytracer_tpu/kernels/megakernel.py::_make_kernel
// (the Pallas kernel dispatched by _pallas_render). It computes the same
// 12 (H, W) f32 planes: r, g, b, miss_dir xyz, miss_thr xyz, jr, jc,
// missed. The env lookup stays deferred to kernel B (env_accumulate.cu).
//
// What bounds it on the card: FP32 issue (no FMA: the parity policy
// builds with --fmad=false) and idle lanes, not memory traffic (12 plane
// stores per pixel against some thousands of flops). With one thread per
// pixel a warp runs until its longest path ends: at 720p most paths die
// after one segment, and only ~0.56 of the lanes of a warp do work.
//
// So the kernel regenerates paths. It is persistent: as many blocks as
// are resident on the card, each loading the scene tables into shared
// memory once and looping (shared memory measured faster than the tables
// in __constant__ memory, whose run-time offsets gain nothing from the
// constant cache; PERF.md). A work item is one pixel with its whole
// sample loop (the wang stream runs on from sample to sample). A warp
// takes chunks of 32 consecutive items with one atomicAdd on a counter
// the entry point zeroes on the stream before each launch. After every
// segment a lane whose item has ended writes its 12 planes and takes the
// next item of the warp's chunk (a ballot and a popc; consecutive free
// lanes get consecutive pixels, so the stores stay partly coalesced); a
// new item casts its camera ray while the other lanes go on bouncing.
// The per-pixel arithmetic and its order are those of the one-thread-
// per-pixel kernel, so every plane is bit-equal to it.
//
// A sample ends where the TPU kernel allows an exit: when its path dies
// (every sample of the counter RNG, the wang stream's last sample) or
// after bounces+1 segments. A wang sample before the last that dies
// still consumes the draws of its remaining segments, in one skip.
//
// A launch renders a window of pixel rows (Params::row0, local_height;
// the whole image is row0 = 0, local_height = height), the counterpart of
// the TPU kernel's row0 scalar under shard_map (parallel/shard.py): its
// items are the window's pixels, and each pixel seeds its RNG and casts
// its camera ray from its global row, so a window's planes are bit-equal
// to those rows of the whole image.
//
// The bounce body lives in bounce.cuh, shared with kernel C (backward.cu),
// whose replay must take exactly this kernel's decisions. Parity policy
// (there): --fmad=false, no fast math, the JAX operand order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bounce.cuh"

namespace {

using namespace cprt;

constexpr int WARPS = 4;  // a block: 4 warps
constexpr int THREADS = 32 * WARPS;
// 5 resident blocks an SM: ptxas fits the kernel in 96 registers (114
// unbounded, 4 blocks), which measured faster at 720p and 1080p; 6
// blocks (80 registers) spill more and measured no faster (PERF.md)
constexpr int MIN_BLOCKS = 5;
constexpr unsigned FULL = 0xffffffffu;

// The jittered primary ray of sample ``s`` (the counter RNG draws one per
// sample; the wang stream's ray, drawn once, is kept in pos0/dir0).
__device__ __forceinline__ void start_sample(Path& p, Rng& rng, const Params& P,
                                             const float* cam, int s, int col, int fy_i,
                                             f3& pos0, f3& dir0) {
    if (rng.counter) {
        rng.key1 = (uint32_t)frame_of(P) * 26699u + (uint32_t)(s + P.sample0) * 40503u + 1u;
        rng.ctr = 0u;
        f3 target;
        camera_ray(rng, P, cam, (float)col, (float)fy_i, pos0, dir0, target);
    }
    p.ret = mk(0.0f, 0.0f, 0.0f);
    p.thr = mk(1.0f, 1.0f, 1.0f);
    p.pos = pos0;
    p.dir = dir0;
    p.alive = true;
    p.missed = false;
    p.miss_dir = mk(0.0f, 0.0f, 1.0f);
    p.miss_thr = mk(0.0f, 0.0f, 0.0f);
    p.jr = 0.0f;
    p.jc = 0.0f;
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
render_planes_kernel(Params P, const float* __restrict__ quad_tbl,
                     const float* __restrict__ sph_tbl,
                     const float* __restrict__ mat_tbl,
                     const float* __restrict__ cam_tbl, float* __restrict__ out,
                     int* __restrict__ counter, unsigned long long* __restrict__ lane_stats) {
    extern __shared__ float smem[];
    const SceneSmem S = load_scene(P, quad_tbl, sph_tbl, mat_tbl, cam_tbl, smem);
    const float *quads = S.quads, *sph = S.sph, *inv_r = S.inv_r, *mats = S.mats,
                *cam = S.cam;
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int n = P.width * P.local_height;  // the window's items
    const size_t sn = (size_t)n;
    const int n_draws = segment_draws(P);

    // the warp's chunk of items (warp-uniform)
    int chunk_next = 0, chunk_end = 0;
    bool chunks_left = true;
    // this lane's item: a pixel, its sample and segment, and its state
    bool busy = false;
    int item = 0, col = 0, fy_i = 0, s = 0, seg = 0;
    Rng rng;
    Path p;
    f3 acc, pos0, dir0;
    unsigned live = 0, slots = 0;  // this warp's lanes that ran a segment, of its slots

    while (true) {
        // free lanes take the next items of the chunk, then of new chunks
        bool fresh = false;
        unsigned idle = __ballot_sync(FULL, !busy);
        while (idle && chunks_left) {
            if (chunk_next == chunk_end) {
                int base = 0;
                if (lane == 0) base = atomicAdd(counter, 32);
                base = __shfl_sync(FULL, base, 0);
                if (base >= n) {
                    chunks_left = false;
                    break;
                }
                chunk_next = base;
                chunk_end = min(base + 32, n);
            }
            const int take = min(__popc(idle), chunk_end - chunk_next);
            const int rank = __popc(idle & ((1u << lane) - 1u));
            if (!busy && rank < take) {
                item = chunk_next + rank;
                busy = fresh = true;
            }
            chunk_next += take;
            idle = __ballot_sync(FULL, !busy);
        }
        const unsigned active = __ballot_sync(FULL, busy);
        if (active == 0u) break;
        live += __popc(active);
        slots += 32;
        if (!busy) continue;

        if (fresh) {
            const int row = item / P.width;  // of the window
            col = item - row * P.width;
            fy_i = (P.height - 1) - (P.row0 + row);
            rng.counter = P.counter_rng != 0;
            rng.state = 0u;
            rng.ctr = 0u;
            rng.key0 = (uint32_t)col * 1973u + (uint32_t)fy_i * 9277u;
            rng.key1 = 0u;
            if (!rng.counter) {
                rng.state = ((uint32_t)col * 1973u + (uint32_t)fy_i * 9277u +
                             (uint32_t)frame_of(P) * 26699u) | 1u;
                // the jittered ray is drawn once per frame, shared by the spp loop
                f3 target;
                camera_ray(rng, P, cam, (float)col, (float)fy_i, pos0, dir0, target);
            }
            acc = mk(0.0f, 0.0f, 0.0f);
            s = 0;
            seg = 0;
            start_sample(p, rng, P, cam, s, col, fy_i, pos0, dir0);
        }

        bounce(p, rng, P, quads, sph, inv_r, mats, cam);
        bool sample_done = seg == P.bounces;
        if (!p.alive) {
            // a dead wang sample before the last may not exit: it still
            // consumes the draws of the segments it would have skipped
            if (!rng.counter && s != P.spp - 1) rng.skip(n_draws * (P.bounces - seg));
            sample_done = true;
        }
        ++seg;
        if (!sample_done) continue;
        acc = add(acc, muls(p.ret, P.inv_spp));
        if (++s < P.spp) {
            seg = 0;
            start_sample(p, rng, P, cam, s, col, fy_i, pos0, dir0);
            continue;
        }
        const size_t i = (size_t)item;
        out[i] = acc.x;
        out[sn + i] = acc.y;
        out[2 * sn + i] = acc.z;
        out[3 * sn + i] = p.miss_dir.x;
        out[4 * sn + i] = p.miss_dir.y;
        out[5 * sn + i] = p.miss_dir.z;
        out[6 * sn + i] = p.miss_thr.x;
        out[7 * sn + i] = p.miss_thr.y;
        out[8 * sn + i] = p.miss_thr.z;
        out[9 * sn + i] = p.jr;
        out[10 * sn + i] = p.jc;
        out[11 * sn + i] = p.missed ? 1.0f : 0.0f;
        busy = false;
    }
    if (lane_stats != nullptr && lane == 0) {
        atomicAdd(&lane_stats[0], (unsigned long long)live);
        atomicAdd(&lane_stats[1], (unsigned long long)slots);
    }
}

// Resident blocks of render_planes_kernel on one SM at this scene's
// shared memory, and the card's SM count.
int resident_blocks(int nq, int ns, int nm, int* per_sm, int* sms) {
    const size_t smem = (size_t)scene_smem_floats(nq, ns, nm) * sizeof(float);
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, render_planes_kernel,
                                                            THREADS, smem);
    return (int)err;
}

}  // namespace

// ``counter`` is one int of scratch the launch uses (zeroed here, on the
// stream); ``lane_stats`` is null, or two zeroed u64 that receive the
// lanes that ran a segment and the lane slots of all warp iterations;
// ``frame_base`` is null, or a device int added to ``frame``. The launch
// renders global rows [row0, row0 + local_height) of the height-row image
// into ``out`` (12, local_height, width). ``most_blocks``
// is the resident grid (cprt_render_planes_resident), queried once by the
// caller: no occupancy query runs here, so a CUDA graph captures the launch.
extern "C" int cprt_render_planes(const float* quad_tbl, int nq, const float* sph_tbl, int ns,
                                  const float* mat_tbl, int nm, const float* cam_tbl,
                                  float* out, int width, int height, int row0,
                                  int local_height, int frame, int sample0,
                                  int spp, int bounces, int counter_rng, int env_draws,
                                  int env_none, int roulette, int zangle, int jitter,
                                  float aspect, float inv_spp, int* counter,
                                  unsigned long long* lane_stats, const int* frame_base,
                                  int most_blocks, void* stream) {
    Params P{width, height, frame, sample0, spp, bounces, nq, ns, nm,
             counter_rng, env_draws, env_none, roulette, zangle, jitter,
             aspect, inv_spp, frame_base, row0, local_height};
    if (row0 < 0 || local_height < 0 || row0 + local_height > height)
        return (int)cudaErrorInvalidValue;
    const long long n = (long long)width * local_height;
    if (n <= 0) return (int)cudaSuccess;
    if (most_blocks <= 0) return (int)cudaErrorInvalidValue;
    const long long needed = (n + THREADS - 1) / THREADS;
    const int blocks = (int)(needed < most_blocks ? needed : most_blocks);
    const size_t smem = (size_t)scene_smem_floats(nq, ns, nm) * sizeof(float);
    int err = (int)cudaMemsetAsync(counter, 0, sizeof(int), (cudaStream_t)stream);
    if (err) return err;
    render_planes_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
        P, quad_tbl, sph_tbl, mat_tbl, cam_tbl, out, counter, lane_stats);
    return (int)cudaGetLastError();
}

// Blocks of kernel A resident on one SM for a scene of these table sizes.
extern "C" int cprt_render_planes_resident(int nq, int ns, int nm, int* per_sm, int* sms) {
    return resident_blocks(nq, ns, nm, per_sm, sms);
}

extern "C" const char* cprt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
