// K4's extended-shading entries: shade_kernel.cu's shading of hit points
// that come in, with the shading extensions of
// raymarching_tpu/ops/pallas_render.py::_shade_body that _shade_kernel
// (:558) compiles when asked: soft shadows (the penumbra factor in each
// shadow march), coloured lights (three sums, the saturation-floor skip
// off) and ambient occlusion, picked by warp-uniform switches (shade.cuh's
// ShadeExt), one entry a normal over the four scene views.  The two-phase
// path (K3, K3, this) gives render_ext_kernel.cu's outputs bitwise.
// Outputs: the light term [3][R] (coloured) or [R], colour winner and
// shadow mask, the winner residuals with the analytic normal, sfac [L][R]
// (soft shadows) and aofac [R] (AO).  Its plain PyTorch twin is
// raymarching_tpu_torch/ops/shade_kernel.py::shade_rays_plain.
//
// Layout, bounds and exactness are shade_kernel.cu's (shade_loop.cuh; no
// fast math, no FMA contraction, so it is bitwise equal to its twin).

// nvcc-flags: -fmad=false

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "shade_loop.cuh"

namespace {

// X is ShadeRaysExt, or FarShadeRaysExt for more than kMaxAoSamples AO taps.
template <class S, class X = ShadeRaysExt>
__global__ void __launch_bounds__(kThreads)
    shade_kernel_ext(const SceneArgs A, const ShadeParams P, const Rays B,
                     const X E) {
  shade_loop<kNormalFd, true, S>(A, P, B, E);
}

template <class S, class X = ShadeRaysExt>
__global__ void __launch_bounds__(kThreads, kAnalyticBlocks)
    shade_kernel_ext_analytic(const SceneArgs A, const ShadeParams P,
                              const Rays B, const X E) {
  shade_loop<kNormalAnalytic, true, S>(A, P, B, E);
}

template <int kNormal, class S, class X = ShadeRaysExt>
auto entry() {
  return kNormal == kNormalAnalytic ? shade_kernel_ext_analytic<S, X>
                                    : shade_kernel_ext<S, X>;
}

}  // namespace

// Launch K4's extended entry on `stream` over R rays: rt_shade_rays'
// arguments (light [3][R] with coloured lights, else [R]), then the
// extensions' switches (soft_k > 0: soft shadows; colored != 0;
// ao_strength > 0 with ao_samples taps at the host array ao_d's distances,
// or past kMaxAoSamples taps at (k + 1) ao_delta)
// and their factor outputs sfac [L][R] and aofac [R] (null when off).
// Returns a CUDA error code.
extern "C" int rt_shade_rays_ext(
    const void* tbl, const void* groups, const void* runs, const void* lat,
    const void* lat_flag, int n_rows, int n_groups, int n_runs, int n_lat,
    int root_min, int view, const void* lights, const void* black,
    int shared, int analytic, int n_lights, int n_black, int shadows,
    int sat_skip, int iterations, float eps, float off, float saturation,
    float fd_h, float soft_k, int colored, float ao_strength, int ao_samples,
    const float* ao_d, double ao_delta, const void* in, void* light,
    void* iout, void* wres,
    void* widx, void* sfac, void* aofac, void* counter, int64_t R,
    void* stream) {
  if (R < 0 || R > kMaxRays || (analytic == 0 && wres != nullptr) ||
      ao_samples < 0 ||
      (soft_k > 0.0f && sfac == nullptr) ||
      (ao_strength > 0.0f && aofac == nullptr))
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
  const auto run = [&](const auto& E) {
    using X = std::decay_t<decltype(E)>;
    return on_view(shared, view, [&](auto v) {
      using S = typename decltype(v)::type;
      return analytic
                 ? launch_persistent<S>(entry<kNormalAnalytic, S, X>(), A, R,
                                        st, A, P, B, E)
                 : launch_persistent<S>(entry<kNormalFd, S, X>(), A, R, st,
                                        A, P, B, E);
    });
  };
  float* const sf = static_cast<float*>(sfac);
  float* const ao = static_cast<float*>(aofac);
  if (ao_samples > kMaxAoSamples)
    return run(FarShadeRaysExt{far_shade_ext(soft_k, colored, ao_strength,
                                             ao_samples, ao_delta),
                               sf, ao});
  ShadeRaysExt E{};
  E.x = shade_ext(soft_k, colored, ao_strength, ao_samples, ao_d);
  E.sfac = sf;
  E.aofac = ao;
  return run(E);
}

// shade_kernel.cu's rt_blocks_per_sm for the extended entries.
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
