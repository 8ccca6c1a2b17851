// K3: the standalone sphere-tracing march.
//
// Replaces raymarching_tpu/ops/pallas_march.py::_march_kernel (the
// pallas_call in _compiled_call; entry pallas_march): march a batch of rays
// for up to `iterations` scene evaluations, optionally stopping each ray at
// its own distance tmax (shadow rays stop at the light), optionally
// counting each ray's evaluations.  The multi-kernel backend marches its
// primary and shadow rays with it, and the two-phase march of the fused
// backend runs it twice (a short first phase over every ray, the rest of
// the budget over the unconverged tail).  Its plain PyTorch twin is
// raymarching_tpu_torch/ops/march_kernel.py::march_rays_plain.
//
// Layout.  One thread per ray, 128 threads a block; origins, directions,
// tmax in and the outputs out are structure-of-arrays rows of [R] float32
// (int32 for the step count), so loads and stores coalesce.  The march and
// the fold are K1's own (march.cuh, fold.cuh).  The evaluation cap is
// exactly `iterations`: the TPU kernel's blocked exit check and its table
// preload answer that machine's costs and are not carried over.
//
// What bounds it.  FP32 instruction rate and divergence, as K1: a ray
// reads 24 to 28 bytes and writes 20 to 24, against some 12 operations per
// leaf for every leaf the fold's cull keeps at every step.  A warp runs until its
// slowest ray is done; the two-phase path exists to take those rays out
// and pack them densely.
//
// Exactness.  No fast math and no FMA contraction (the nvcc-flags line
// below), like K1: the kernel is bitwise equal to its twin and its hit
// points are K1's.  The distance along a shadow ray is the projection
// (p - o) . d, not the sum of steps, as in the TPU kernel.

// nvcc-flags: -fmad=false

#include <cuda_runtime.h>

#include <cstdint>

#include "march.cuh"

namespace {

constexpr int kThreads = 128;

struct Params {
  Scene scene;
  int iterations;
  float eps;
  const float* org;    // [3][R] per-ray origins, or null
  float ox, oy, oz;    // the shared origin when org is null
  const float* dirs;   // [3][R]
  const float* tmax;   // [R], or null: no distance limit
  float* out;          // [5][R]: px, py, pz, sd, done
  int* steps;          // [R], or null: no step count
  int64_t R;
};

__global__ void __launch_bounds__(kThreads) march_kernel(const Params P) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= P.R) return;
  const int64_t R = P.R;
  float ox = P.ox, oy = P.oy, oz = P.oz;
  if (P.org != nullptr) {
    ox = P.org[i];
    oy = P.org[R + i];
    oz = P.org[2 * R + i];
  }
  const float dx = P.dirs[i], dy = P.dirs[R + i], dz = P.dirs[2 * R + i];
  const bool has_tmax = P.tmax != nullptr;
  const float tmax = has_tmax ? P.tmax[i] : 0.0f;
  const Hit hit = march(P.scene, P.iterations, P.eps, ox, oy, oz, dx, dy, dz,
                        has_tmax, tmax, false);
  P.out[i] = hit.x;
  P.out[R + i] = hit.y;
  P.out[2 * R + i] = hit.z;
  P.out[3 * R + i] = hit.sd;
  P.out[4 * R + i] = hit.done ? 1.0f : 0.0f;
  if (P.steps != nullptr) P.steps[i] = hit.steps;
}

}  // namespace

// Launch K3 on `stream` over R rays; returns cudaGetLastError().
extern "C" int rt_march_rays(const void* tbl, const void* groups,
                             const void* runs, int n_groups, int root_min,
                             int iterations, float eps, const void* org,
                             float ox, float oy, float oz, const void* dirs,
                             const void* tmax, void* out, void* steps,
                             int64_t R, void* stream) {
  Params P;
  P.scene = Scene{static_cast<const float4*>(tbl),
                  static_cast<const int4*>(groups),
                  static_cast<const int4*>(runs), n_groups, root_min};
  P.iterations = iterations;
  P.eps = eps;
  P.org = static_cast<const float*>(org);
  P.ox = ox;
  P.oy = oy;
  P.oz = oz;
  P.dirs = static_cast<const float*>(dirs);
  P.tmax = static_cast<const float*>(tmax);
  P.out = static_cast<float*>(out);
  P.steps = static_cast<int*>(steps);
  P.R = R;
  if (R > 0) {
    const unsigned blocks = static_cast<unsigned>((R + kThreads - 1) / kThreads);
    march_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(P);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
