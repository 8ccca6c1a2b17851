// K2: scene SD, winner leaf and winner gradient at given points.
//
// Replaces raymarching_tpu/ops/pallas_march.py::_surface_kernel (the
// pallas_call in _compiled_surface_call; entry pallas_surface_eval) in its
// combined mode (with_color, with_normal, analytic; not fused): per point
// the scene SD, the first-wins winning leaf, and the winner's gradient
// d scene / dp = gsign * scale * d leaf / dp, as _scene_sd_idx_grad_tile
// folds it.  The exact-FD backward (ops/render_op.py) launches it once over
// the 7-point stencil of every hit.  Its plain PyTorch twin is
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
// What bounds it.  FP32 ALU issue, as K1: some 10 flops per leaf for every
// leaf the cull keeps, against 12 bytes read and 20 written per point.  No
// march, so no lane waits on a slower neighbour's iterations; lanes of one
// warp still differ in which groups the cull skips.
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
__device__ float3 leaf_grad(const float4* tbl, int type, int i, float px,
                            float py, float pz) {
  const float4 a = __ldg(tbl + 2 * i);
  const float dx = px - a.x, dy = py - a.y, dz = pz - a.z;
  if (type == kSphere) {
    const float r = sqrtf(dx * dx + dy * dy + dz * dz);
    const float inv = 1.0f / fmaxf(r, 1e-30f);
    return make_float3(dx * inv, dy * inv, dz * inv);
  }
  const float4 b = __ldg(tbl + 2 * i + 1);
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

__global__ void __launch_bounds__(kThreads)
    surface_kernel(const Scene s, const float* q, float* out, int* widx,
                   int64_t N) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= N) return;
  const float px = q[i], py = q[N + i], pz = q[2 * N + i];
  const Winner w = scene_sd_idx(s, px, py, pz);

  // the run that holds the winner: its prim type and path sign
  // gsign * scale (the root's rsign cancels in the chain rule)
  float3 g = make_float3(0.0f, 0.0f, 0.0f);
  if (w.idx >= 0) {
    int type = kSphere;
    float path = 1.0f;
    for (int gi = 0; gi < s.n_groups; ++gi) {
      const int4 grp = __ldg(s.groups + gi);
      for (int k = grp.y; k < grp.y + grp.z; ++k) {
        const int4 run = __ldg(s.runs + k);
        if (w.idx >= run.y && w.idx < run.y + run.z) {
          type = run.x;
          path = static_cast<float>(grp.x * run.w);
        }
      }
    }
    const float3 lg = leaf_grad(s.tbl, type, w.idx, px, py, pz);
    g = make_float3(path * lg.x, path * lg.y, path * lg.z);
  }
  out[i] = w.sd;
  out[N + i] = g.x;
  out[2 * N + i] = g.y;
  out[3 * N + i] = g.z;
  widx[i] = w.idx;
}

}  // namespace

// Launch K2 on `stream` over N points q [3][N]; out [4][N] (sd, gx, gy,
// gz), widx [N].  Returns cudaGetLastError().
extern "C" int rt_surface_eval(const void* tbl, const void* groups,
                               const void* runs, int n_groups, int root_min,
                               const void* q, void* out, void* widx,
                               int64_t N, void* stream) {
  const Scene s{static_cast<const float4*>(tbl),
                static_cast<const int4*>(groups),
                static_cast<const int4*>(runs), n_groups, root_min};
  if (N > 0) {
    const unsigned blocks = static_cast<unsigned>((N + kThreads - 1) / kThreads);
    surface_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        s, static_cast<const float*>(q), static_cast<float*>(out),
        static_cast<int*>(widx), N);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
