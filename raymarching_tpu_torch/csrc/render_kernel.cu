// K1: the renderer's whole per-ray forward pipeline in one launch.
//
// Replaces raymarching_tpu/ops/pallas_render.py::_render_kernel (the
// pallas_call in _compiled_render_call; entry pallas_render_rays) for the
// reference shading model: primary march; first-wins colour winner at the
// pre-step point; 6-eval central-difference normal; one shadow march per
// light that stops at the light, with the black-lane and saturation-floor
// skips; Lambert sum clamped to [saturation, 1].  Its plain PyTorch twin is
// raymarching_tpu_torch/ops/render_kernel.py::render_rays_plain.
//
// The march and the shading are march.cuh and shade.cuh, which K3
// (march_kernel.cu) and K4 (shade_kernel.cu) include too: the two-phase
// path (K3, K3, K4) therefore gives this kernel's outputs bitwise.
//
// Layout.  One thread per ray, 128 threads a block.  Ray inputs and outputs
// are structure-of-arrays rows of [R] float32, so loads and stores coalesce.
// The scene fold (fold.cuh, shared with K2) walks the int32 group and run
// descriptors of tables.pack_plan with warp-uniform control flow: every
// lane reads the same descriptor and the same primitive row at the same
// time, so the prim-type switch does not diverge and the row reads
// broadcast from the read-only cache.  The table stays in device memory
// (menger4's 8,424 rows are 270 KB, more than a block's shared memory), and
// one build serves every scene.
//
// What bounds it.  FP32 ALU issue and divergence, not bytes: a ray reads 24
// bytes and writes 32, against some 10 flops per leaf for every leaf of the
// scene at every march step.  A ray is frozen once done, so the lanes of a
// warp idle until its slowest ray finishes each march.  Making it fast is
// later work: warp-coherent pixel blocks (block ray order), the exact Menger
// lattice collapse, and code generated per plan.
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

#include "shade.cuh"

namespace {

constexpr int kThreads = 128;

struct Params {
  Scene scene;
  ShadeParams shade;      // also the primary march's iterations and eps
  const float* org;       // [3][R] per-ray origins, or null
  float ox, oy, oz;       // the shared origin when org is null
  const float* dirs;      // [3][R]
  float* out;             // [6][R]: px, py, pz, sd, done, light
  int* iout;              // [2][R]: colour winner, shadow mask
  int64_t R;
};

__global__ void __launch_bounds__(kThreads) render_kernel(const Params P) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= P.R) return;
  const int64_t R = P.R;
  const Scene s = P.scene;
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
  const Shade sh = shade(s, P.shade, hit.x, hit.y, hit.z, hit.sd, dx, dy, dz);

  P.out[i] = hit.x;
  P.out[R + i] = hit.y;
  P.out[2 * R + i] = hit.z;
  P.out[3 * R + i] = hit.sd;
  P.out[4 * R + i] = hit.done ? 1.0f : 0.0f;
  P.out[5 * R + i] = sh.light;
  P.iout[i] = sh.cidx;
  P.iout[R + i] = sh.smask;
}

}  // namespace

// Launch K1 on `stream` over R rays; returns cudaGetLastError().
extern "C" int rt_render_rays(const void* tbl, const void* lights,
                              const void* groups, const void* runs,
                              const void* black, int n_groups, int root_min,
                              int n_lights, int n_black, int shadows,
                              int sat_skip, int iterations, float eps,
                              float off, float saturation, float fd_h,
                              const void* org, float ox, float oy, float oz,
                              const void* dirs, void* out, void* iout,
                              int64_t R, void* stream) {
  Params P;
  P.scene = Scene{static_cast<const float4*>(tbl),
                  static_cast<const int4*>(groups),
                  static_cast<const int4*>(runs), n_groups, root_min};
  P.shade = ShadeParams{static_cast<const float4*>(lights),
                        static_cast<const int*>(black),
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
  P.R = R;
  if (R > 0) {
    const unsigned blocks = static_cast<unsigned>((R + kThreads - 1) / kThreads);
    render_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(P);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
