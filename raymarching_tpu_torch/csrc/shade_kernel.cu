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
// 1] (the reference shading model; white lights).  The normal is a
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

#include "persist.cuh"
#include "shade.cuh"

namespace {

// The rays' buffers: in [7][R] (p xyz, sd, direction xyz), light [R],
// iout [2][R] (colour winner, shadow mask), and with the analytic normal
// the winner residuals wres [4][R] (sd, gx, gy, gz) and widx [R], or null.
struct Rays {
  const float* in;
  float* light;
  int* iout;
  float* wres;
  int* widx;
  unsigned* counter;   // [1]: the next ray to hand out, zero at launch
  unsigned R;
};

// The rays of one thread, the body of both entry kernels.
template <int kNormal, class S>
__device__ __forceinline__ void shade_loop(const SceneArgs& A,
                                           const ShadeParams& P,
                                           const Rays& B) {
  const S s = stage_scene<S>(A);
  const unsigned R = B.R;
  const float* in = B.in;
  for (;;) {
    const unsigned base = next_rays(B.counter);
    if (base >= R) break;
    const unsigned i = base + (threadIdx.x & 31u);
    if (i >= R) continue;
    const Shade sh = shade<kNormal>(
        s, P, in[i], in[R + i], in[2 * R + i], in[3 * R + i], in[4 * R + i],
        in[5 * R + i], in[6 * R + i], WinnerOut{B.wres, B.widx, i, R});
    B.light[i] = sh.light;
    B.iout[i] = sh.cidx;
    B.iout[R + i] = sh.smask;
  }
}

// The entries, one a normal, with the launch bounds shade.cuh's
// kAnalyticBlocks explains.
template <class S>
__global__ void __launch_bounds__(kThreads)
    shade_kernel(const SceneArgs A, const ShadeParams P, const Rays B) {
  shade_loop<kNormalFd, S>(A, P, B);
}

template <class S>
__global__ void __launch_bounds__(kThreads, kAnalyticBlocks)
    shade_kernel_analytic(const SceneArgs A, const ShadeParams P,
                          const Rays B) {
  shade_loop<kNormalAnalytic, S>(A, P, B);
}

// The entry kernel for normal kNormal over scene view S.
template <int kNormal, class S>
auto entry() {
  return kNormal == kNormalAnalytic ? shade_kernel_analytic<S>
                                    : shade_kernel<S>;
}

template <int kNormal, class S>
int launch(const SceneArgs& A, const ShadeParams& P, const Rays& B,
           cudaStream_t stream) {
  const unsigned smem = staged_bytes<S>(A);
  unsigned blocks = 0;
  const int err = persistent_blocks(entry<kNormal, S>(), smem, B.R, &blocks);
  if (err != 0) return err;
  entry<kNormal, S>()<<<blocks, kThreads, smem, stream>>>(A, P, B);
  return static_cast<int>(cudaGetLastError());
}

template <int kNormal>
int launch_view(const SceneArgs& A, const ShadeParams& P, const Rays& B,
                int shared, int fused, cudaStream_t stream) {
  if (fused)
    return shared ? launch<kNormal, Fused<SharedScene>>(A, P, B, stream)
                  : launch<kNormal, Fused<DeviceScene>>(A, P, B, stream);
  return shared ? launch<kNormal, SharedScene>(A, P, B, stream)
                : launch<kNormal, DeviceScene>(A, P, B, stream);
}

// Resident blocks an SM of the entry for normal kNormal over view S.
template <int kNormal, class S>
int occupancy(unsigned smem, int* per_sm) {
  return blocks_per_sm(entry<kNormal, S>(), smem, per_sm);
}

template <int kNormal>
int occupancy_view(int shared, int fused, unsigned smem, int* per_sm) {
  if (fused)
    return shared ? occupancy<kNormal, Fused<SharedScene>>(smem, per_sm)
                  : occupancy<kNormal, Fused<DeviceScene>>(smem, per_sm);
  return shared ? occupancy<kNormal, SharedScene>(smem, per_sm)
                : occupancy<kNormal, DeviceScene>(smem, per_sm);
}

}  // namespace

// Launch K4 on `stream` over R rays: in [7][R] (p xyz, sd, direction xyz),
// light [R], iout [2][R] (colour winner, shadow mask); the scene staged in
// shared memory (`shared` != 0) or read from device memory, the plan
// packed with fused generators (`fused` != 0) or exact; the FD normal
// (`analytic` == 0) or the analytic one, and with it and `wres` not null
// the winner residuals wres [4][R] (sd, gx, gy, gz) and widx [R];
// `counter` is one zeroed int32.  Returns a CUDA error code.
extern "C" int rt_shade_rays(const void* tbl, const void* groups,
                             const void* runs, const void* lat,
                             const void* lat_flag, int n_rows, int n_groups,
                             int n_runs, int n_lat, int root_min, int fused,
                             const void* lights, const void* black,
                             int shared, int analytic, int n_lights,
                             int n_black, int shadows, int sat_skip,
                             int iterations, float eps, float off,
                             float saturation, float fd_h, const void* in,
                             void* light, void* iout, void* wres, void* widx,
                             void* counter, int64_t R, void* stream) {
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
  if (R < 0 || R > kMaxRays || (analytic == 0 && wres != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaGetLastError());
  const Rays B{static_cast<const float*>(in), static_cast<float*>(light),
               static_cast<int*>(iout),       static_cast<float*>(wres),
               static_cast<int*>(widx),       static_cast<unsigned*>(counter),
               static_cast<unsigned>(R)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return analytic ? launch_view<kNormalAnalytic>(s, P, B, shared, fused, st)
                  : launch_view<kNormalFd>(s, P, B, shared, fused, st);
}

// Resident blocks an SM of this kernel with `staged` bytes of scene in
// shared memory (`shared` != 0) or with the scene in device memory, with
// the FD normal (`analytic` == 0) or the analytic one, exact or fused
// (`fused` != 0), for reports; negative: a CUDA error code.
extern "C" int rt_blocks_per_sm(int shared, int staged, int analytic,
                                int fused) {
  int per_sm = 0;
  const unsigned smem = shared ? static_cast<unsigned>(staged) : 0u;
  const int err =
      analytic ? occupancy_view<kNormalAnalytic>(shared, fused, smem, &per_sm)
               : occupancy_view<kNormalFd>(shared, fused, smem, &per_sm);
  return err != 0 ? -err : per_sm;
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
