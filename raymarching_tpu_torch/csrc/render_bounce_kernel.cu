// K1's mirror-bounce entries: render_ext_kernel.cu's pipeline (and
// render_raygen_kernel.cu's, with the directions from the ray index)
// followed by `bounces` mirror bounces, the branch of
// raymarching_tpu/ops/pallas_render.py::_render_kernel at :284-309
// (RenderConfig.reflect_strength > 0, reflect_bounces): reflect the
// direction off the shaded hit's unit normal, lift the origin off the
// surface like a shadow ray, march and shade again.  Each shade set (the
// primary hit's and one a bounce) and each bounce's hit geometry goes out
// in rows of its own (render.cuh's bounce_ray), for the colour blend
// (ops/render_kernel.blend) and the backward's anchored replay
// (ops/render_op, JAX's _reflect_bwd).  The bounce count is a runtime
// argument: one march and one shade in the code.
//
// Four entries, FD or analytic normal times directions from a buffer or
// from the ray index (JAX's serving path runs bounces in its raygen form
// too, serve_render_chunk), each over the four scene views; every one has
// the extended shading with PR 8's warp-uniform switches, so one build
// serves every combination of soft shadows, AO and coloured lights.  No
// winner residuals (the replay backward owns bounce chains) and no
// black-lane skip (the host passes none, as JAX passes black_ids = ()); the
// saturation-floor skip stays, exact for every shade.  Its plain PyTorch
// twin is raymarching_tpu_torch/ops/render_kernel.py::render_rays_plain
// (and render_raygen_plain) with bounces.
//
// What bounds it is K1's: the marches' dependent chains (operations, not
// bytes: a ray reads 24 bytes and writes 28 + 16 a bounce plus the
// factors).  A bounce adds a march, a shade and its shadow marches, so a
// frame with B bounces costs up to 1 + B times K1's.  Exactness is
// render_kernel.cu's: no fast math, no FMA contraction.

// nvcc-flags: -fmad=false

#include <cuda_runtime.h>

#include <cstdint>

#include "render.cuh"

namespace {

// X is RenderExt, or FarRenderExt for more than kMaxAoSamples AO taps.
template <class S, class X = RenderExt>
__global__ void __launch_bounds__(kThreads)
    render_kernel_bounce(const Params P, const X E, const int B) {
  render_loop<kNormalFd, true, false, S, X, NoExt, true>(P, E, NoExt{}, B);
}

template <class S, class X = RenderExt>
__global__ void __launch_bounds__(kThreads, kAnalyticBlocks)
    render_kernel_bounce_analytic(const Params P, const X E, const int B) {
  render_loop<kNormalAnalytic, true, false, S, X, NoExt, true>(
      P, E, NoExt{}, B);
}

template <class S, class X = RenderExt>
__global__ void __launch_bounds__(kThreads)
    render_kernel_raygen_bounce(const Params P, const X E, const Raygen G,
                                const int B) {
  render_loop<kNormalFd, true, true, S, X, Raygen, true>(P, E, G, B);
}

template <class S, class X = RenderExt>
__global__ void __launch_bounds__(kThreads, kAnalyticBlocks)
    render_kernel_raygen_bounce_analytic(const Params P, const X E,
                                         const Raygen G, const int B) {
  render_loop<kNormalAnalytic, true, true, S, X, Raygen, true>(P, E, G, B);
}

// Launch the entry for (analytic, raygen) over view S; X is E's type.
template <class S, class X>
int launch(int analytic, int raygen, const SceneArgs& scene, const Params& P,
           const X& E, const Raygen& G, int B, cudaStream_t st) {
  const int64_t R = P.R;
  if (raygen)
    return analytic ? launch_persistent<S>(
                          render_kernel_raygen_bounce_analytic<S, X>, scene,
                          R, st, P, E, G, B)
                    : launch_persistent<S>(render_kernel_raygen_bounce<S, X>,
                                           scene, R, st, P, E, G, B);
  return analytic ? launch_persistent<S>(render_kernel_bounce_analytic<S, X>,
                                         scene, R, st, P, E, B)
                  : launch_persistent<S>(render_kernel_bounce<S, X>, scene,
                                         R, st, P, E, B);
}

template <class S>
int occupancy(int analytic, int raygen, unsigned smem, int* per_sm) {
  if (raygen)
    return analytic
               ? blocks_per_sm(render_kernel_raygen_bounce_analytic<S>, smem,
                               per_sm)
               : blocks_per_sm(render_kernel_raygen_bounce<S>, smem, per_sm);
  return analytic ? blocks_per_sm(render_kernel_bounce_analytic<S>, smem,
                                  per_sm)
                  : blocks_per_sm(render_kernel_bounce<S>, smem, per_sm);
}

}  // namespace

// Launch K1's bounce entry on `stream` over R rays with `bounces` >= 0
// mirror bounces: rt_render_rays_ext's arguments up to ao_delta, then the
// bounce count, then `raygen`: nonzero takes rays base..base + R - 1 of a
// W x H frame at SSAA k x k with rt_render_raygen's camera arguments (bh,
// bw, rk, rW, rH, cam) and ignores org, ox, oy, oz and dirs; zero takes those
// (org [3][R] or null for the shared origin (ox, oy, oz), dirs [3][R])
// and ignores the camera.  Outputs, one set of rows for the primary hit
// and one a bounce (render.cuh's bounce_ray): out [(1 + bounces)][5][R],
// iout [(1 + bounces)][2][R], light [(1 + bounces)][C][R], sfac
// [(1 + bounces)][L][R] and aofac [(1 + bounces)][R] (null when off).
// Returns a CUDA error code.
extern "C" int rt_render_bounce(
    const void* tbl, const void* groups, const void* runs, const void* lat,
    const void* lat_flag, int n_rows, int n_groups, int n_runs, int n_lat,
    int root_min, int view, const void* lights, const void* black,
    int shared, int analytic, int n_lights, int n_black, int shadows,
    int sat_skip, int iterations, float eps, float off, float saturation,
    float fd_h, float soft_k, int colored, float ao_strength, int ao_samples,
    const float* ao_d, double ao_delta, int bounces, int raygen, int W,
    int H, int k, int bh, int bw,
    float rk, float rW, float rH, const void* cam, int64_t base,
    const void* org, float ox, float oy, float oz, const void* dirs,
    void* out, void* iout, void* light, void* sfac, void* aofac,
    void* counter, int64_t R, void* stream) {
  if (!valid_launch(R, analytic, nullptr) || bounces < 0 ||
      ao_samples < 0 || light == nullptr ||
      (soft_k > 0.0f && sfac == nullptr) ||
      (ao_strength > 0.0f && aofac == nullptr) ||
      (raygen && (W < 1 || H < 1 || k < 1 || base < 0 || cam == nullptr ||
                  !valid_block(W, H, bh, bw))) ||
      (!raygen && dirs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaGetLastError());
  const SceneArgs scene =
      scene_args(tbl, groups, runs, lat, lat_flag, lights, n_rows, n_groups,
                 n_runs, n_lat, n_lights, root_min);
  const Params P = make_params(
      scene,
      ShadeParams{static_cast<const int*>(black), n_lights, n_black, shadows,
                  sat_skip, iterations, eps, off, saturation, fd_h},
      raygen ? nullptr : org, ox, oy, oz, raygen ? nullptr : dirs, out, iout,
      nullptr, nullptr, counter, R);
  Raygen G{};
  if (raygen) {
    G.W = W;
    G.H = H;
    G.k = k;
    G.bh = bh;
    G.bw = bw;
    G.rk = rk;
    G.rW = rW;
    G.rH = rH;
    G.cam = static_cast<const float*>(cam);
    G.base = base;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto run = [&](const auto& E) {
    return on_view(shared, view, [&](auto v) {
      return launch<typename decltype(v)::type>(analytic, raygen, scene, P,
                                                E, G, bounces, st);
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

// Resident blocks an SM of the bounce entry for (analytic, raygen), as
// render_kernel.cu's rt_blocks_per_sm.
extern "C" int rt_blocks_per_sm(int shared, int staged, int analytic,
                                int view, int raygen) {
  int per_sm = 0;
  const unsigned smem = shared ? static_cast<unsigned>(staged) : 0u;
  const int err = on_view(shared, view, [&](auto v) {
    return occupancy<typename decltype(v)::type>(analytic, raygen, smem,
                                                 &per_sm);
  });
  return err != 0 ? -err : per_sm;
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
