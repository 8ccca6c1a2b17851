// K4: K1's shading on hit points that come in.
//
// Replaces raymarching_tpu/ops/pallas_render.py::_shade_kernel (the
// pallas_call in _compiled_shade_call), the second half of the fused
// backend's two-phase path: the hit points come from K3 (march_kernel.cu)
// instead of a march inside the kernel.  Per ray, from (hit point, last
// SD, direction): the first-wins colour winner at the pre-step point, the
// 6-eval central-difference normal, one shadow march per light that stops
// at the light, with the black-lane and saturation-floor skips, and the
// Lambert sum clamped to [saturation, 1] (the reference shading model;
// white lights).  Its plain PyTorch twin is
// raymarching_tpu_torch/ops/shade_kernel.py::shade_rays_plain.
//
// Layout.  K1's: a persistent grid, the scene and the lights staged in
// each block's shared memory when they fit, each warp taking 32
// consecutive rays at a time from a counter (persist.cuh), one thread per
// ray; the seven input rows (p xyz, sd, direction xyz) and the outputs are
// structure-of-arrays rows of [R], so loads and stores coalesce.  The
// shading is shade.cuh, the very function K1 calls after its own march.
//
// What bounds it.  Not bytes (28 read and 12 written per ray) and not the
// instruction rate, but the latency of the fold's dependent chain, over
// seven folds and up to `iterations` shadow-march steps per light; the
// shadow marches are 94% of its device time on the demo (shade.cuh has
// the reading and the two designs that were measured and taken out).  It
// shares K1's answers: the lattice collapse in the value folds, the scene
// in shared memory, warps that draw their own work.  The lanes of a warp
// wait on its slowest shadow ray, and its one winner fold a ray visits
// every cross.
//
// Exactness.  No fast math and no FMA contraction (the nvcc-flags line
// below), so it is bitwise equal to its twin, and K3 + K4 to K1.

// nvcc-flags: -fmad=false

#include <cuda_runtime.h>

#include <cstdint>

#include "persist.cuh"
#include "shade.cuh"

namespace {

template <class S>
__global__ void __launch_bounds__(kThreads)
    shade_kernel(const SceneArgs A, const ShadeParams P, const float* in,
                 float* light, int* iout, unsigned* counter, unsigned R) {
  const S s = stage_scene<S>(A);
  for (;;) {
    const unsigned base = next_rays(counter);
    if (base >= R) break;
    const unsigned i = base + (threadIdx.x & 31u);
    if (i >= R) continue;
    const Shade sh =
        shade(s, P, in[i], in[R + i], in[2 * R + i], in[3 * R + i],
              in[4 * R + i], in[5 * R + i], in[6 * R + i]);
    light[i] = sh.light;
    iout[i] = sh.cidx;
    iout[R + i] = sh.smask;
  }
}

template <class S>
int launch(const SceneArgs& A, const ShadeParams& P, const float* in,
           float* light, int* iout, unsigned* counter, unsigned R,
           cudaStream_t stream) {
  const unsigned smem = staged_bytes<S>(A);
  unsigned blocks = 0;
  const int err = persistent_blocks(shade_kernel<S>, smem, R, &blocks);
  if (err != 0) return err;
  shade_kernel<S><<<blocks, kThreads, smem, stream>>>(A, P, in, light, iout,
                                                      counter, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch K4 on `stream` over R rays: in [7][R] (p xyz, sd, direction xyz),
// light [R], iout [2][R] (colour winner, shadow mask); the scene staged in
// shared memory (`shared` != 0) or read from device memory; `counter` is
// one zeroed int32.  Returns a CUDA error code.
extern "C" int rt_shade_rays(const void* tbl, const void* groups,
                             const void* runs, const void* lat,
                             const void* lat_flag, int n_rows, int n_groups,
                             int n_runs, int n_lat, int root_min,
                             const void* lights, const void* black,
                             int shared, int n_lights, int n_black,
                             int shadows, int sat_skip, int iterations,
                             float eps, float off, float saturation,
                             float fd_h, const void* in, void* light,
                             void* iout, void* counter, int64_t R,
                             void* stream) {
  const SceneArgs s = scene_args(tbl, groups, runs, lat, lat_flag, lights,
                                 n_rows, n_groups, n_runs, n_lat, n_lights,
                                 root_min);
  const ShadeParams P{static_cast<const int*>(black),
                      n_lights,
                      n_black,
                      shadows,
                      sat_skip,
                      iterations,
                      eps,
                      off,
                      saturation,
                      fd_h};
  if (R < 0 || R > kMaxRays) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* inf = static_cast<const float*>(in);
  float* lf = static_cast<float*>(light);
  int* io = static_cast<int*>(iout);
  unsigned* ctr = static_cast<unsigned*>(counter);
  const unsigned n = static_cast<unsigned>(R);
  return shared ? launch<SharedScene>(s, P, inf, lf, io, ctr, n, st)
                : launch<DeviceScene>(s, P, inf, lf, io, ctr, n, st);
}

// Resident blocks an SM of this kernel with `staged` bytes of scene in
// shared memory (`shared` != 0) or with the scene in device memory, for
// reports; negative: a CUDA error code.
extern "C" int rt_blocks_per_sm(int shared, int staged) {
  int per_sm = 0;
  const int err =
      shared ? blocks_per_sm(shade_kernel<SharedScene>,
                             static_cast<unsigned>(staged), &per_sm)
             : blocks_per_sm(shade_kernel<DeviceScene>, 0u, &per_sm);
  return err != 0 ? -err : per_sm;
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
