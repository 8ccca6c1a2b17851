// K4: K1's shading on hit points that come in.
//
// Replaces raymarching_tpu/ops/pallas_render.py::_shade_kernel (the
// pallas_call in _compiled_shade_call), the second half of the fused
// backend's two-phase path: the hit points come from K3 (march_kernel.cu)
// instead of a march inside the kernel.  Per ray, from (hit point, last
// SD, direction): the first-wins colour winner at the pre-step point, the
// 6-eval central-difference normal or the analytic one (with the winner
// residuals of the fused backward when asked, exactly as K1 writes them),
// one shadow march per light that stops at the light, with the black-lane
// and saturation-floor skips, and the Lambert sum clamped to [saturation,
// 1] (the reference shading model; its extensions are the entries of
// shade_ext_kernel.cu over the same loop, shade_loop.cuh).  The normal is a
// template argument.  Its plain PyTorch twin is
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

#include "shade_loop.cuh"

namespace {

// The entries, one a normal, with the launch bounds shade.cuh's
// kAnalyticBlocks explains.
template <class S>
__global__ void __launch_bounds__(kThreads)
    shade_kernel(const SceneArgs A, const ShadeParams P, const Rays B) {
  shade_loop<kNormalFd, false, S>(A, P, B);
}

template <class S>
__global__ void __launch_bounds__(kThreads, kAnalyticBlocks)
    shade_kernel_analytic(const SceneArgs A, const ShadeParams P,
                          const Rays B) {
  shade_loop<kNormalAnalytic, false, S>(A, P, B);
}

// The entry kernel for normal kNormal over scene view S.
template <int kNormal, class S>
auto entry() {
  return kNormal == kNormalAnalytic ? shade_kernel_analytic<S>
                                    : shade_kernel<S>;
}

}  // namespace

// Launch K4 on `stream` over R rays: in [7][R] (p xyz, sd, direction xyz),
// light [R], iout [2][R] (colour winner, shadow mask); the scene staged in
// shared memory (`shared` != 0) or read from device memory, in scene
// view `view` (persist.cuh's on_view); the FD normal
// (`analytic` == 0) or the analytic one, and with it and `wres` not null
// the winner residuals wres [4][R] (sd, gx, gy, gz) and widx [R];
// `counter` is one zeroed int32.  Returns a CUDA error code.
extern "C" int rt_shade_rays(const void* tbl, const void* groups,
                             const void* runs, const void* lat,
                             const void* lat_flag, int n_rows, int n_groups,
                             int n_runs, int n_lat, int root_min, int view,
                             const void* lights, const void* black,
                             int shared, int analytic, int n_lights,
                             int n_black, int shadows, int sat_skip,
                             int iterations, float eps, float off,
                             float saturation, float fd_h, const void* in,
                             void* light, void* iout, void* wres, void* widx,
                             void* counter, int64_t R, void* stream) {
  if (R < 0 || R > kMaxRays || (analytic == 0 && wres != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaGetLastError());
  const SceneArgs A = scene_args(tbl, groups, runs, lat, lat_flag, lights,
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
  const Rays B = make_rays(in, light, iout, wres, widx, counter, R);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_view(shared, view, [&](auto v) {
    using S = typename decltype(v)::type;
    return analytic ? launch_persistent<S>(entry<kNormalAnalytic, S>(), A, R,
                                           st, A, P, B)
                    : launch_persistent<S>(entry<kNormalFd, S>(), A, R, st,
                                           A, P, B);
  });
}

// Resident blocks an SM of this kernel with `staged` bytes of scene in
// shared memory (`shared` != 0) or with the scene in device memory, with
// the FD normal (`analytic` == 0) or the analytic one, in scene view
// `view`, for reports; negative: a CUDA error code.
extern "C" int rt_blocks_per_sm(int shared, int staged, int analytic,
                                int view) {
  int per_sm = 0;
  const unsigned smem = shared ? static_cast<unsigned>(staged) : 0u;
  const int err = on_view(shared, view, [&](auto v) {
    using S = typename decltype(v)::type;
    return analytic
               ? blocks_per_sm(entry<kNormalAnalytic, S>(), smem, &per_sm)
               : blocks_per_sm(entry<kNormalFd, S>(), smem, &per_sm);
  });
  return err != 0 ? -err : per_sm;
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
