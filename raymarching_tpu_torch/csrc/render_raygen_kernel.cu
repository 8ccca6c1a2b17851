// K1's in-kernel raygen entries: render_kernel.cu's pipeline (and
// render_ext_kernel.cu's, with the shading extensions) with each thread
// computing its primary direction from the ray index, the serving path of
// raymarching_tpu/ops/pallas_render.py::_render_kernel with `raygen`
// (_raygen_dirs, :162, called at :259; api._render_mega_serve).  A frame
// then needs no camera pass on the host, no [3][R] direction buffer and
// no reorder: the rays of a chunk are rays base..base + R - 1 of the
// frame in scan order (pixel-major, SSAA sample minor), the layout
// core.camera.generate_rays gives, and the ray index is an integer (the
// JAX kernel's float32 index limits a frame to 2^24 rays; this one does
// not).  With a pixel block (bh, bw) the ray index is in block order
// instead (core.order.to_blocked, the JAX kernel's `bh, bw` branch, :183-
// 190): a warp's 32 rays then cover a compact block of pixels, and the
// wrapper puts the outputs back in scan order.  Forward only, as the JAX
// path is.
//
// Four entries, reference or extended shading times FD or analytic
// normal, each over the four scene views.  Outputs are render_kernel.cu's
// (and with the extensions render_ext_kernel.cu's), so on directions that
// are bitwise the raygen twin's (core.camera.raygen_dirs) an entry gives
// the outputs of the reference or extended entry on those directions
// bitwise.  Its plain PyTorch twin is core.camera.raygen_dirs followed by
// ops/render_kernel.py::render_rays_plain (render_raygen_plain).
//
// Exactness is render_kernel.cu's: no fast math, no FMA contraction.

// nvcc-flags: -fmad=false

#include <cuda_runtime.h>

#include <cstdint>

#include "render.cuh"

namespace {

template <class S>
__global__ void __launch_bounds__(kThreads)
    render_kernel_raygen(const Params P, const Raygen G) {
  render_loop<kNormalFd, false, true, S>(P, NoExt{}, G);
}

template <class S>
__global__ void __launch_bounds__(kThreads, kAnalyticBlocks)
    render_kernel_raygen_analytic(const Params P, const Raygen G) {
  render_loop<kNormalAnalytic, false, true, S>(P, NoExt{}, G);
}

// X is RenderExt, or FarRenderExt for more than kMaxAoSamples AO taps.
template <class S, class X = RenderExt>
__global__ void __launch_bounds__(kThreads)
    render_kernel_raygen_ext(const Params P, const X E, const Raygen G) {
  render_loop<kNormalFd, true, true, S>(P, E, G);
}

template <class S, class X = RenderExt>
__global__ void __launch_bounds__(kThreads, kAnalyticBlocks)
    render_kernel_raygen_ext_analytic(const Params P, const X E,
                                      const Raygen G) {
  render_loop<kNormalAnalytic, true, true, S>(P, E, G);
}

// Launch the entry for (analytic, ext) over view S; X is E's type.
template <class S, class X>
int launch(int analytic, int ext, const SceneArgs& scene, const Params& P,
           const X& E, const Raygen& G, cudaStream_t st) {
  const int64_t R = P.R;
  if (ext)
    return analytic ? launch_persistent<S>(
                          render_kernel_raygen_ext_analytic<S, X>, scene, R,
                          st, P, E, G)
                    : launch_persistent<S>(render_kernel_raygen_ext<S, X>,
                                           scene, R, st, P, E, G);
  return analytic ? launch_persistent<S>(render_kernel_raygen_analytic<S>,
                                         scene, R, st, P, G)
                  : launch_persistent<S>(render_kernel_raygen<S>, scene, R,
                                         st, P, G);
}

template <class S>
int occupancy(int analytic, int ext, unsigned smem, int* per_sm) {
  if (ext)
    return analytic ? blocks_per_sm(render_kernel_raygen_ext_analytic<S>,
                                    smem, per_sm)
                    : blocks_per_sm(render_kernel_raygen_ext<S>, smem,
                                    per_sm);
  return analytic
             ? blocks_per_sm(render_kernel_raygen_analytic<S>, smem, per_sm)
             : blocks_per_sm(render_kernel_raygen<S>, smem, per_sm);
}

}  // namespace

// Launch K1's raygen entry on `stream` over rays base..base + R - 1 of a
// W x H frame at SSAA k x k, in scan order or, with bh, bw > 0, in block
// order of bh x bw pixel blocks (core.order.to_blocked; bh | H, bw | W):
// rt_render_rays' arguments less the origins and the directions, then
// with `ext` != 0 rt_render_rays_ext's extension switches and outputs
// (ignored with `ext` == 0: the reference shading, light in out's row 5),
// then the camera: rk, rW, rH (1/k, 1/W, 1/H as float32) and cam, the
// device copy of core.camera.serve_cam_rows' [3][8] rows (the origin is
// the camera position there).  Returns a CUDA error code.
extern "C" int rt_render_raygen(
    const void* tbl, const void* groups, const void* runs, const void* lat,
    const void* lat_flag, int n_rows, int n_groups, int n_runs, int n_lat,
    int root_min, int view, const void* lights, const void* black,
    int shared, int analytic, int n_lights, int n_black, int shadows,
    int sat_skip, int iterations, float eps, float off, float saturation,
    float fd_h, int ext, float soft_k, int colored, float ao_strength,
    int ao_samples, const float* ao_d, double ao_delta, int W, int H, int k,
    int bh, int bw, float rk,
    float rW, float rH, const void* cam, int64_t base, void* out,
    void* iout, void* wres, void* widx, void* light,
    void* sfac, void* aofac, void* counter, int64_t R, void* stream) {
  if (!valid_launch(R, analytic, wres) || W < 1 || H < 1 || k < 1 ||
      base < 0 || cam == nullptr || !valid_block(W, H, bh, bw) ||
      (ext && (ao_samples < 0 || light == nullptr ||
               (soft_k > 0.0f && sfac == nullptr) ||
               (ao_strength > 0.0f && aofac == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaGetLastError());
  const SceneArgs scene =
      scene_args(tbl, groups, runs, lat, lat_flag, lights, n_rows, n_groups,
                 n_runs, n_lat, n_lights, root_min);
  const Params P = make_params(
      scene,
      ShadeParams{static_cast<const int*>(black), n_lights, n_black, shadows,
                  sat_skip, iterations, eps, off, saturation, fd_h},
      nullptr, 0.0f, 0.0f, 0.0f, nullptr, out, iout, wres, widx, counter,
      R);
  Raygen G{};
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto run = [&](const auto& E) {
    return on_view(shared, view, [&](auto v) {
      return launch<typename decltype(v)::type>(analytic, ext, scene, P, E,
                                                G, st);
    });
  };
  float* const lt = static_cast<float*>(light);
  float* const sf = static_cast<float*>(sfac);
  float* const ao = static_cast<float*>(aofac);
  if (ext && ao_samples > kMaxAoSamples)
    return run(FarRenderExt{far_shade_ext(soft_k, colored, ao_strength,
                                          ao_samples, ao_delta),
                            lt, sf, ao});
  RenderExt E{};
  if (ext) {
    E.x = shade_ext(soft_k, colored, ao_strength, ao_samples, ao_d);
    E.light = lt;
    E.sfac = sf;
    E.aofac = ao;
  }
  return run(E);
}

// Resident blocks an SM of the raygen entry for (analytic, ext), as
// render_kernel.cu's rt_blocks_per_sm.
extern "C" int rt_blocks_per_sm(int shared, int staged, int analytic,
                                int view, int ext) {
  int per_sm = 0;
  const unsigned smem = shared ? static_cast<unsigned>(staged) : 0u;
  const int err = on_view(shared, view, [&](auto v) {
    return occupancy<typename decltype(v)::type>(analytic, ext, smem,
                                                 &per_sm);
  });
  return err != 0 ? -err : per_sm;
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
