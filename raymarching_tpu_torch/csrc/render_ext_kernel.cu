// K1's extended-shading entries: render_kernel.cu's pipeline with the
// shading extensions of raymarching_tpu/ops/pallas_render.py::_shade_body
// (the branches of _render_kernel's shade body that the reference shading
// model has not): soft shadows (the penumbra factor tracked in each shadow
// march, _march_values' soft_k, :40-137, and sfac, :517-524), coloured
// lights (three sums, :526-531, with the saturation-floor skip off, :427)
// and ambient occlusion (:541-549).  One entry a normal, over the same four
// scene views as the reference entries; inside an entry warp-uniform
// switches pick the extensions (shade.cuh's ShadeExt), so one build serves
// every combination of them.  Outputs: render_kernel.cu's rows 0-4 and
// int rows, the light term [3][R] (coloured) or [R], and the factors the
// backward replay reapplies: sfac [L][R] (soft shadows), aofac [R] (AO).
// Its plain PyTorch twin is
// raymarching_tpu_torch/ops/render_kernel.py::render_rays_plain.
//
// Layout, bounds and exactness are render_kernel.cu's (render.cuh's loop,
// persistent blocks, the scene staged; no fast math, no FMA contraction,
// so it is bitwise equal to its twin).  What the extensions add to a ray:
// a division and a min per shadow-march step (soft shadows), two more sums
// a light (coloured), and ao_samples scene evaluations at the hit (AO).

// nvcc-flags: -fmad=false

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "render.cuh"

namespace {

// X is RenderExt, or FarRenderExt for more than kMaxAoSamples AO taps.
template <class S, class X = RenderExt>
__global__ void __launch_bounds__(kThreads)
    render_kernel_ext(const Params P, const X E) {
  render_loop<kNormalFd, true, false, S>(P, E);
}

template <class S, class X = RenderExt>
__global__ void __launch_bounds__(kThreads, kAnalyticBlocks)
    render_kernel_ext_analytic(const Params P, const X E) {
  render_loop<kNormalAnalytic, true, false, S>(P, E);
}

template <int kNormal, class S, class X = RenderExt>
auto entry() {
  return kNormal == kNormalAnalytic ? render_kernel_ext_analytic<S, X>
                                    : render_kernel_ext<S, X>;
}

}  // namespace

// Launch K1's extended entry on `stream` over R rays: rt_render_rays'
// arguments (out [5][R] here: px, py, pz, sd, done), then the extensions'
// switches (soft_k > 0: soft shadows; colored != 0; ao_strength > 0 with
// ao_samples taps at the host array ao_d's distances, or past
// kMaxAoSamples taps at (k + 1) ao_delta) and their outputs:
// light [3][R] or [R], sfac [L][R] and aofac [R] (null when off).
// Returns a CUDA error code.
extern "C" int rt_render_rays_ext(
    const void* tbl, const void* groups, const void* runs, const void* lat,
    const void* lat_flag, int n_rows, int n_groups, int n_runs, int n_lat,
    int root_min, int view, const void* lights, const void* black,
    int shared, int analytic, int n_lights, int n_black, int shadows,
    int sat_skip, int iterations, float eps, float off, float saturation,
    float fd_h, float soft_k, int colored, float ao_strength, int ao_samples,
    const float* ao_d, double ao_delta, const void* org, float ox, float oy,
    float oz,
    const void* dirs, void* out, void* iout, void* wres, void* widx,
    void* light, void* sfac, void* aofac, void* counter, int64_t R,
    void* stream) {
  if (!valid_launch(R, analytic, wres) || ao_samples < 0 ||
      (soft_k > 0.0f && sfac == nullptr) ||
      (ao_strength > 0.0f && aofac == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaGetLastError());
  const SceneArgs scene =
      scene_args(tbl, groups, runs, lat, lat_flag, lights, n_rows, n_groups,
                 n_runs, n_lat, n_lights, root_min);
  const Params P = make_params(
      scene,
      ShadeParams{static_cast<const int*>(black), n_lights, n_black, shadows,
                  sat_skip, iterations, eps, off, saturation, fd_h},
      org, ox, oy, oz, dirs, out, iout, wres, widx, counter, R);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto run = [&](const auto& E) {
    using X = std::decay_t<decltype(E)>;
    return on_view(shared, view, [&](auto v) {
      using S = typename decltype(v)::type;
      return analytic
                 ? launch_persistent<S>(entry<kNormalAnalytic, S, X>(),
                                        scene, R, st, P, E)
                 : launch_persistent<S>(entry<kNormalFd, S, X>(), scene, R,
                                        st, P, E);
    });
  };
  float* const lt = static_cast<float*>(light);
  float* const sf = static_cast<float*>(sfac);
  float* const ao = static_cast<float*>(aofac);
  if (ao_samples > kMaxAoSamples)
    return run(FarRenderExt{far_shade_ext(soft_k, colored, ao_strength,
                                          ao_samples, ao_delta),
                            lt, sf, ao});
  RenderExt E{};
  E.x = shade_ext(soft_k, colored, ao_strength, ao_samples, ao_d);
  E.light = lt;
  E.sfac = sf;
  E.aofac = ao;
  return run(E);
}

// render_kernel.cu's rt_blocks_per_sm for the extended entries.
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
