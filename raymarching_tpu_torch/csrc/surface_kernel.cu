// K2: the scene evaluated at given points, in four modes.
//
// Replaces raymarching_tpu/ops/pallas_march.py::_surface_kernel (the
// pallas_call in _compiled_surface_call; entry pallas_surface_eval), not
// fused:
//   * combined (with_color, with_normal, analytic): per point the scene
//     SD, the first-wins winning leaf, and the winner's gradient d scene /
//     dp = gsign * scale * d leaf / dp, as _scene_sd_idx_grad_tile folds
//     it.  The exact-FD backward (ops/render_op.py) launches it once over
//     the 7-point stencil of every hit, MarchOp once over the hit points,
//     NormalOp once over the 6-point stencil;
//   * sd: the scene SD alone;
//   * winner (with_color): the SD and the winning leaf, the multi-kernel
//     backend's colour lookup at the pre-step points;
//   * fd (with_normal): the SD and the central-difference gradient
//     (f(p + h e_a) - f(p - h e_a)) * (1 / 2h) from six more folds, the
//     multi-kernel backend's normals.
// The gradient-only analytic mode and the fused-generator modes are not
// ported yet.  Its plain PyTorch twin is
// raymarching_tpu_torch/ops/surface_kernel.py::surface_eval_plain.
//
// Layout.  One thread per point, 128 threads a block; points in and
// outputs out are structure-of-arrays rows of [N] float32 (int32 for the
// winner), so loads and stores coalesce.  The fold is K1's own winner fold
// (fold.cuh): the same descriptors, rows, order and per-lane DIFFERENCE
// base-bound cull.
//
// Design.  The JAX kernel carries the gradient through every select of the
// fold.  Only the winner's gradient survives, and sign flips are exact, so
// this kernel folds (sd, winner) and then evaluates the gradient of the
// winning leaf alone, with the path sign of the run that holds it: the same
// bits, for one leaf gradient per point instead of one per leaf.
//
// What bounds it.  The combined mode on the backward's stencils: bytes
// (12 read and 20 written per point against a fold the cull keeps short).
// The other modes: operations, as K1, with the latency of the fold's
// dependent chain (descriptor, row, min) ahead of the instruction rate.
// The sd and fd modes fold through scene_sd and so take the exact Menger
// lattice collapse with K1; the winner modes visit every leaf the cull
// keeps.  No march, so no lane waits on a slower neighbour's iterations;
// lanes of one warp still differ in which groups the cull skips.  The
// scene is read from device memory through the read-only cache: this
// kernel is one thread per point with no persistent blocks to stage it.
//
// Exactness.  No fast math and, like K1, no FMA contraction (the
// nvcc-flags line below): the backward's FD normal divides stencil SD
// differences by 2 fd_h (fd_h = 1e-3), which turns an ulp of SD into 500
// ulps of gradient, so the stencil SDs must be the very values the forward
// folded.  Sign of a zero coordinate is 0, as jnp.sign gives it.

// nvcc-flags: -fmad=false

#include <cuda_runtime.h>

#include <cstdint>

#include "fold.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float sgn(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
}

// d leaf sd / dp of leaf i of prim type `type` (pallas_march._prim_sd_grad):
// sphere (p - c) / max(|p - c|, 1e-30); box one-hot sign on the first
// argmax axis (ties to x, then y); cross one-hot sign on the median axis.
__device__ float3 leaf_grad(const DeviceScene& s, int type, int i, float px,
                            float py, float pz) {
  const float4 a = s.row(2 * i);
  const float dx = px - a.x, dy = py - a.y, dz = pz - a.z;
  if (type == kSphere) {
    const float r = sqrtf(dx * dx + dy * dy + dz * dz);
    const float inv = 1.0f / fmaxf(r, 1e-30f);
    return make_float3(dx * inv, dy * inv, dz * inv);
  }
  const float4 b = s.row(2 * i + 1);
  const float bx = fabsf(dx) - a.w * 0.5f;
  const float by = fabsf(dy) - b.x * 0.5f;
  const float bz = fabsf(dz) - b.y * 0.5f;
  const float sx = sgn(dx), sy = sgn(dy), sz = sgn(dz);
  const bool max_x = bx >= fmaxf(by, bz);
  const bool max_y = !max_x && by >= bz;
  if (type == kBox)
    return make_float3(max_x ? sx : 0.0f, max_y ? sy : 0.0f,
                       (max_x || max_y) ? 0.0f : sz);
  const bool min_x = bx <= fminf(by, bz);
  const bool min_y = !min_x && by <= bz;
  const bool med_x = !(max_x || min_x);
  const bool med_y = !(max_y || min_y || med_x);
  const bool med_z = !(med_x || med_y);
  return make_float3(med_x ? sx : 0.0f, med_y ? sy : 0.0f,
                     med_z ? sz : 0.0f);
}

// ops/surface_kernel.py's mode codes
constexpr int kCombined = 0;
constexpr int kSdOnly = 1;
constexpr int kWinner = 2;
constexpr int kFdGrad = 3;

// the winner's gradient: the run that holds it gives its prim type and
// path sign gsign * scale (the root's rsign cancels in the chain rule)
__device__ float3 winner_grad(const DeviceScene& s, int idx, float px,
                              float py, float pz) {
  if (idx < 0) return make_float3(0.0f, 0.0f, 0.0f);
  int type = kSphere;
  float path = 1.0f;
  for (int gi = 0; gi < s.n_groups; ++gi) {
    const int4 grp = s.group(gi);
    for (int k = grp.y; k < grp.y + grp.z; ++k) {
      const int4 run = s.run(k);
      if (idx >= run.y && idx < run.y + run.z) {
        type = run.x;
        path = static_cast<float>(grp.x * run.w);
      }
    }
  }
  const float3 lg = leaf_grad(s, type, idx, px, py, pz);
  return make_float3(path * lg.x, path * lg.y, path * lg.z);
}

// out: [4][N] (sd, gx, gy, gz) in the combined and fd modes, else [1][N];
// widx: [N] in the combined and winner modes, else unused.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
    surface_kernel(const SceneArgs A, const float* q, float inv_2h, float h,
                   float* out, int* widx, int64_t N) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= N) return;
  const DeviceScene s = device_scene(A);
  const float px = q[i], py = q[N + i], pz = q[2 * N + i];
  if (kMode == kCombined || kMode == kWinner) {
    const Winner w = scene_sd_idx(s, px, py, pz);
    out[i] = w.sd;
    widx[i] = w.idx;
    if (kMode == kCombined) {
      const float3 g = winner_grad(s, w.idx, px, py, pz);
      out[N + i] = g.x;
      out[2 * N + i] = g.y;
      out[3 * N + i] = g.z;
    }
    return;
  }
  out[i] = scene_sd(s, px, py, pz);
  if (kMode == kFdGrad) {
    // pallas_march._surface_kernel's order of operations: the difference
    // first, then one multiplication by 1 / 2h
    const float gx = scene_sd(s, px + h, py, pz) - scene_sd(s, px - h, py, pz);
    const float gy = scene_sd(s, px, py + h, pz) - scene_sd(s, px, py - h, pz);
    const float gz = scene_sd(s, px, py, pz + h) - scene_sd(s, px, py, pz - h);
    out[N + i] = gx * inv_2h;
    out[2 * N + i] = gy * inv_2h;
    out[3 * N + i] = gz * inv_2h;
  }
}

}  // namespace

// Launch K2 in `mode` on `stream` over N points q [3][N]; out and widx as
// surface_kernel takes them; h and inv_2h (= 1 / 2h, rounded by the
// caller) are read in the fd mode only.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an unknown mode.
extern "C" int rt_surface_eval(const void* tbl, const void* groups,
                               const void* runs, const void* lat,
                               const void* lat_flag, int n_rows, int n_groups,
                               int n_runs, int n_lat, int root_min, int mode,
                               float h, float inv_2h, const void* q, void* out,
                               void* widx, int64_t N, void* stream) {
  const SceneArgs s = scene_args(tbl, groups, runs, lat, lat_flag, nullptr,
                                 n_rows, n_groups, n_runs, n_lat, 0,
                                 root_min);
  if (mode < kCombined || mode > kFdGrad)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N > 0) {
    const unsigned blocks = static_cast<unsigned>((N + kThreads - 1) / kThreads);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* qf = static_cast<const float*>(q);
    float* of = static_cast<float*>(out);
    int* wi = static_cast<int*>(widx);
    switch (mode) {
      case kCombined:
        surface_kernel<kCombined><<<blocks, kThreads, 0, st>>>(
            s, qf, inv_2h, h, of, wi, N);
        break;
      case kSdOnly:
        surface_kernel<kSdOnly><<<blocks, kThreads, 0, st>>>(
            s, qf, inv_2h, h, of, wi, N);
        break;
      case kWinner:
        surface_kernel<kWinner><<<blocks, kThreads, 0, st>>>(
            s, qf, inv_2h, h, of, wi, N);
        break;
      default:
        surface_kernel<kFdGrad><<<blocks, kThreads, 0, st>>>(
            s, qf, inv_2h, h, of, wi, N);
        break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
