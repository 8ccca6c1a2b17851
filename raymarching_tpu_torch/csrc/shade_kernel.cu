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
// Layout.  One thread per ray, 128 threads a block; the seven input rows
// (p xyz, sd, direction xyz) and the outputs are structure-of-arrays rows
// of [R], so loads and stores coalesce.  The shading is shade.cuh, the
// very function K1 calls after its own march.
//
// What bounds it.  FP32 instruction rate and divergence: 28 bytes read and
// 12 written per ray against seven folds and up to `iterations` shadow-march
// steps per light.  The lanes of a warp wait on its slowest shadow ray.
//
// Exactness.  No fast math and no FMA contraction (the nvcc-flags line
// below), so it is bitwise equal to its twin, and K3 + K4 to K1.

// nvcc-flags: -fmad=false

#include <cuda_runtime.h>

#include <cstdint>

#include "shade.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    shade_kernel(const Scene s, const ShadeParams P, const float* in,
                 float* light, int* iout, int64_t R) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= R) return;
  const Shade sh = shade(s, P, in[i], in[R + i], in[2 * R + i], in[3 * R + i],
                         in[4 * R + i], in[5 * R + i], in[6 * R + i]);
  light[i] = sh.light;
  iout[i] = sh.cidx;
  iout[R + i] = sh.smask;
}

}  // namespace

// Launch K4 on `stream` over R rays: in [7][R] (p xyz, sd, direction xyz),
// light [R], iout [2][R] (colour winner, shadow mask).  Returns
// cudaGetLastError().
extern "C" int rt_shade_rays(const void* tbl, const void* lights,
                             const void* groups, const void* runs,
                             const void* black, int n_groups, int root_min,
                             int n_lights, int n_black, int shadows,
                             int sat_skip, int iterations, float eps,
                             float off, float saturation, float fd_h,
                             const void* in, void* light, void* iout,
                             int64_t R, void* stream) {
  const Scene s{static_cast<const float4*>(tbl),
                static_cast<const int4*>(groups),
                static_cast<const int4*>(runs), n_groups, root_min};
  const ShadeParams P{static_cast<const float4*>(lights),
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
  if (R > 0) {
    const unsigned blocks = static_cast<unsigned>((R + kThreads - 1) / kThreads);
    shade_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        s, P, static_cast<const float*>(in), static_cast<float*>(light),
        static_cast<int*>(iout), R);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
