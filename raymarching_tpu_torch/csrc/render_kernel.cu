// K1: the renderer's whole per-ray forward pipeline in one launch.
//
// Replaces raymarching_tpu/ops/pallas_render.py::_render_kernel (the
// pallas_call in _compiled_render_call; entry pallas_render_rays) for the
// reference shading model, on exact tables or with fused generators (the
// scene view Fused<S>, fold.cuh; an instantiation each): primary march; first-wins colour winner at the
// pre-step point; 6-eval central-difference normal, or the analytic
// normal (the winner's gradient at the hit, which can also be written out
// as the fused backward's residuals: JAX's save_winner); one shadow march
// per light that stops at the light, with the black-lane and
// saturation-floor skips; Lambert sum clamped to [saturation, 1].  The
// normal is a template argument: one instantiation each.  Its plain
// PyTorch twin is
// raymarching_tpu_torch/ops/render_kernel.py::render_rays_plain.
//
// The march and the shading are march.cuh and shade.cuh, which K3
// (march_kernel.cu) and K4 (shade_kernel.cu) include too: the two-phase
// path (K3, K3, K4) therefore gives this kernel's outputs bitwise.
//
// Layout.  A persistent grid (persist.cuh): as many blocks of 128 threads
// as the card holds at once; each stages the scene and the lights in its
// shared memory when they fit (menger4's 8,424 rows, 270 KB, do not: that
// scene runs the device-memory instantiation of the same kernel), then
// each warp renders 32 consecutive rays at a time, one thread per ray,
// taking the next 32 from a counter until none is left.  Ray inputs and
// outputs are structure-of-arrays rows of [R] float32, so loads and stores
// coalesce.  The scene fold (fold.cuh, shared with K2) walks the int32
// group and run descriptors of tables.pack_plan with warp-uniform control
// flow: every lane reads the same descriptor and the same primitive row at
// the same time, so the prim-type switch does not diverge and the reads
// broadcast.  One build serves every scene.
//
// What bounds it.  Operations, not bytes: a ray reads 24 bytes and writes
// 32, against some 50 scene evaluations (the march, six stencil points, a
// shadow march per light), and within an evaluation the latency of a
// dependent chain (descriptor, row, min) more than the instruction rate.
// The design answers with the exact Menger lattice collapse in the value
// fold (a carve costs a seventh of its leaf fold), with the scene in
// shared memory, and with warps that draw their own work.  What is left:
// the lanes of a warp wait for its slowest ray in each march (busy 87% of
// the primary march and 76% of the shadow marches on the demo,
// chip_smoke.py's [warp] phase: too little idle for a finished lane to
// take a new ray), and the winner fold still visits every cross.
//
// Exactness.  Built without fast math (IEEE sqrtf and division), and, by
// this kernel's own choice (the nvcc-flags line below; ops/build.py adds
// it to this kernel's build only), without FMA contraction, so every
// operation rounds once, as each PyTorch op of the plain twin does, and
// the kernel is bitwise equal to its twin.  A contracted build is about 9%
// faster at 1024x768 SSAA 3 on an H100 but moves a few chaotic hit points
// by up to ~1e-3, past the twin comparison's 1e-4 bound; dropping the flag
// needs that comparison restated as an agreement share.  The winner fold
// keeps strict < (the earliest leaf wins ties) and the cross SDF's median
// is the min/max network.  The saturation-floor bound and the shade loop
// take the Lambert term from one non-inlined function, so the bound holds
// for the loop's total bitwise whatever the compiler does with either call
// site.

// nvcc-flags: -fmad=false

#include <cuda_runtime.h>

#include <cstdint>

#include "persist.cuh"
#include "shade.cuh"

namespace {

struct Params {
  SceneArgs scene;
  ShadeParams shade;      // also the primary march's iterations and eps
  const float* org;       // [3][R] per-ray origins, or null
  float ox, oy, oz;       // the shared origin when org is null
  const float* dirs;      // [3][R]
  float* out;             // [6][R]: px, py, pz, sd, done, light
  int* iout;              // [2][R]: colour winner, shadow mask
  float* wres;            // analytic: [4][R] winner sd, gx, gy, gz, or null
  int* widx;              // analytic: [R] winner leaf (with wres)
  unsigned* counter;      // [1]: the next ray to hand out, zero at launch
  unsigned R;
};

// The rays of one thread, the body of both entry kernels.
template <int kNormal, class S>
__device__ __forceinline__ void render_loop(const Params& P) {
  const S s = stage_scene<S>(P.scene);
  const unsigned R = P.R;
  for (;;) {
    const unsigned base = next_rays(P.counter);
    if (base >= R) break;
    const unsigned i = base + (threadIdx.x & 31u);
    if (i >= R) continue;
    float ox = P.ox, oy = P.oy, oz = P.oz;
    if (P.org != nullptr) {
      ox = P.org[i];
      oy = P.org[R + i];
      oz = P.org[2 * R + i];
    }
    const float dx = P.dirs[i], dy = P.dirs[R + i], dz = P.dirs[2 * R + i];

    // 1. primary march
    const Hit hit = march(s, P.shade.iterations, P.shade.eps, ox, oy, oz, dx,
                          dy, dz, false, 0.0f, false);

    // 2-4. colour winner, normal, shadows, Lambert clamp
    const Shade sh =
        shade<kNormal>(s, P.shade, hit.x, hit.y, hit.z, hit.sd, dx, dy, dz,
                       WinnerOut{P.wres, P.widx, i, R});

    P.out[i] = hit.x;
    P.out[R + i] = hit.y;
    P.out[2 * R + i] = hit.z;
    P.out[3 * R + i] = hit.sd;
    P.out[4 * R + i] = hit.done ? 1.0f : 0.0f;
    P.out[5 * R + i] = sh.light;
    P.iout[i] = sh.cidx;
    P.iout[R + i] = sh.smask;
  }
}

// The entries, one a normal, with the launch bounds shade.cuh's
// kAnalyticBlocks explains.
template <class S>
__global__ void __launch_bounds__(kThreads) render_kernel(const Params P) {
  render_loop<kNormalFd, S>(P);
}

template <class S>
__global__ void __launch_bounds__(kThreads, kAnalyticBlocks)
    render_kernel_analytic(const Params P) {
  render_loop<kNormalAnalytic, S>(P);
}

// The entry kernel for normal kNormal over scene view S.
template <int kNormal, class S>
auto entry() {
  return kNormal == kNormalAnalytic ? render_kernel_analytic<S>
                                    : render_kernel<S>;
}

template <int kNormal, class S>
int launch(const Params& P, cudaStream_t stream) {
  const unsigned smem = staged_bytes<S>(P.scene);
  unsigned blocks = 0;
  const int err = persistent_blocks(entry<kNormal, S>(), smem, P.R, &blocks);
  if (err != 0) return err;
  entry<kNormal, S>()<<<blocks, kThreads, smem, stream>>>(P);
  return static_cast<int>(cudaGetLastError());
}

template <int kNormal>
int launch_view(const Params& P, int shared, int fused,
                cudaStream_t stream) {
  if (fused)
    return shared ? launch<kNormal, Fused<SharedScene>>(P, stream)
                  : launch<kNormal, Fused<DeviceScene>>(P, stream);
  return shared ? launch<kNormal, SharedScene>(P, stream)
                : launch<kNormal, DeviceScene>(P, stream);
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

// Launch K1 on `stream` over R rays, the scene staged in shared memory
// (`shared` != 0) or read from device memory, the plan packed with fused
// generators (`fused` != 0) or exact, with the FD normal
// (`analytic` == 0) or the analytic one; with the analytic normal and
// `wres` not null, also the winner residuals wres [4][R] (sd, gx, gy, gz)
// and widx [R].  `counter` is one zeroed int32.  Returns a CUDA error
// code.
extern "C" int rt_render_rays(const void* tbl, const void* groups,
                              const void* runs, const void* lat,
                              const void* lat_flag, int n_rows, int n_groups,
                              int n_runs, int n_lat, int root_min, int fused,
                              const void* lights, const void* black,
                              int shared, int analytic, int n_lights,
                              int n_black, int shadows, int sat_skip,
                              int iterations, float eps, float off,
                              float saturation, float fd_h, const void* org,
                              float ox, float oy, float oz, const void* dirs,
                              void* out, void* iout, void* wres, void* widx,
                              void* counter, int64_t R, void* stream) {
  Params P;
  P.scene = scene_args(tbl, groups, runs, lat, lat_flag, lights, n_rows,
                       n_groups, n_runs, n_lat, n_lights, root_min);
  P.shade = ShadeParams{static_cast<const int*>(black),
                        n_lights,
                        n_black,
                        shadows,
                        sat_skip,
                        iterations,
                        eps,
                        off,
                        saturation,
                        fd_h};
  P.org = static_cast<const float*>(org);
  P.ox = ox;
  P.oy = oy;
  P.oz = oz;
  P.dirs = static_cast<const float*>(dirs);
  P.out = static_cast<float*>(out);
  P.iout = static_cast<int*>(iout);
  P.wres = static_cast<float*>(wres);
  P.widx = static_cast<int*>(widx);
  P.counter = static_cast<unsigned*>(counter);
  if (R < 0 || R > kMaxRays) return static_cast<int>(cudaErrorInvalidValue);
  P.R = static_cast<unsigned>(R);
  if (R == 0) return static_cast<int>(cudaGetLastError());
  if (analytic == 0 && wres != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return analytic ? launch_view<kNormalAnalytic>(P, shared, fused, st)
                  : launch_view<kNormalFd>(P, shared, fused, st);
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
