// Kernel A: forward path-tracing megakernel for Hopper (sm_90a).
//
// Replaces cpuperformanceraytracer_tpu/kernels/megakernel.py::_make_kernel
// (the Pallas kernel dispatched by _pallas_render). It computes the same
// 12 (H, W) f32 planes: r, g, b, miss_dir xyz, miss_thr xyz, jr, jc,
// missed. The env lookup stays deferred to kernel B (env_accumulate.cu).
//
// Shape: one thread per pixel, looping over samples and bounce segments;
// 32x4-thread blocks, so a warp is 32 neighbouring pixels of one row.
// The scene tables (~330 floats for glass_spheres) are copied into shared
// memory at block start. The TPU kernel's block-level early exit becomes
// a per-thread exit, legal exactly where the TPU kernel allows one: every
// sample of the counter RNG and the last sample of the wang RNG. A dead
// segment that may not exit still consumes its draws.
//
// What bounds it on the card: FP32 issue and warp divergence from the
// material lottery, not memory traffic (12 plane stores per pixel against
// some thousands of flops). This first version is the simple, exact one;
// warp-level reorganisation of paths is later work.
//
// The bounce body lives in bounce.cuh, shared with kernel C (backward.cu),
// whose replay must take exactly this kernel's decisions. Parity policy
// (there): --fmad=false, no fast math, the JAX operand order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bounce.cuh"

namespace {

using namespace cprt;

__global__ void __launch_bounds__(128)
render_planes_kernel(Params P, const float* __restrict__ quad_tbl,
                     const float* __restrict__ sph_tbl,
                     const float* __restrict__ mat_tbl,
                     const float* __restrict__ cam_tbl, float* __restrict__ out) {
    extern __shared__ float smem[];
    const SceneSmem S = load_scene(P, quad_tbl, sph_tbl, mat_tbl, cam_tbl, smem);
    const float *quads = S.quads, *sph = S.sph, *inv_r = S.inv_r, *mats = S.mats,
                *cam = S.cam;
    __syncthreads();

    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = blockIdx.y * blockDim.y + threadIdx.y;
    if (col >= P.width || row >= P.height) return;

    const int fy_i = (P.height - 1) - row;
    const float frag_x = (float)col;
    const float frag_y = (float)fy_i;
    const int n_draws = segment_draws(P);

    Rng rng;
    rng.counter = P.counter_rng != 0;
    rng.state = 0u;
    rng.ctr = 0u;
    rng.key0 = (uint32_t)col * 1973u + (uint32_t)fy_i * 9277u;
    rng.key1 = 0u;

    f3 acc = mk(0.0f, 0.0f, 0.0f);
    Path p;
    f3 pos0, dir0, target;
    if (!rng.counter) {
        rng.state = ((uint32_t)col * 1973u + (uint32_t)fy_i * 9277u +
                     (uint32_t)P.frame * 26699u) | 1u;
        // the jittered ray is drawn once per frame, shared by the spp loop
        camera_ray(rng, P, cam, frag_x, frag_y, pos0, dir0, target);
    }
    for (int s = 0; s < P.spp; ++s) {
        if (rng.counter) {
            rng.key1 = (uint32_t)P.frame * 26699u +
                       (uint32_t)(s + P.sample0) * 40503u + 1u;
            rng.ctr = 0u;
            camera_ray(rng, P, cam, frag_x, frag_y, pos0, dir0, target);
        }
        // skipping a dead segment skips its draws: legal for every counter
        // sample and for the wang stream's last sample only
        const bool allow_exit = P.early_exit && (rng.counter || s == P.spp - 1);
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
        for (int seg = 0; seg <= P.bounces; ++seg) {
            if (!p.alive) {
                if (allow_exit) break;
                rng.skip(n_draws);  // a dead segment only advances the stream
                continue;
            }
            bounce(p, rng, P, quads, sph, inv_r, mats, cam);
        }
        acc = add(acc, muls(p.ret, P.inv_spp));
    }

    const size_t n = (size_t)P.width * P.height;
    const size_t i = (size_t)row * P.width + col;
    out[i] = acc.x;
    out[n + i] = acc.y;
    out[2 * n + i] = acc.z;
    out[3 * n + i] = p.miss_dir.x;
    out[4 * n + i] = p.miss_dir.y;
    out[5 * n + i] = p.miss_dir.z;
    out[6 * n + i] = p.miss_thr.x;
    out[7 * n + i] = p.miss_thr.y;
    out[8 * n + i] = p.miss_thr.z;
    out[9 * n + i] = p.jr;
    out[10 * n + i] = p.jc;
    out[11 * n + i] = p.missed ? 1.0f : 0.0f;
}

}  // namespace

extern "C" int cprt_render_planes(const float* quad_tbl, int nq, const float* sph_tbl, int ns,
                                  const float* mat_tbl, int nm, const float* cam_tbl,
                                  float* out, int width, int height, int frame, int sample0,
                                  int spp, int bounces, int counter_rng, int env_draws,
                                  int env_none, int roulette, int zangle, int jitter,
                                  int early_exit, float aspect, float inv_spp,
                                  void* stream) {
    Params P{width, height, frame, sample0, spp, bounces, nq, ns, nm,
             counter_rng, env_draws, env_none, roulette, zangle, jitter,
             early_exit, aspect, inv_spp};
    const size_t smem = (size_t)scene_smem_floats(nq, ns, nm) * sizeof(float);
    const dim3 block(32, 4);
    const dim3 grid((width + 31) / 32, (height + 3) / 4);
    render_planes_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
        P, quad_tbl, sph_tbl, mat_tbl, cam_tbl, out);
    return (int)cudaGetLastError();
}

extern "C" const char* cprt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
