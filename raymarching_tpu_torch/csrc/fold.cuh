// The scene fold shared by all four kernels: K1 (render_kernel.cu), K2
// (surface_kernel.cu), K3 (march_kernel.cu) and K4 (shade_kernel.cu).
//
// Leaf distances and the two-level kernel-form fold of
// pallas_march._scene_sd_tile / _scene_sd_idx_tile over the int32 group and
// run descriptors of tables.pack_plan.  Every kernel includes this one
// definition, so the SDs K2 evaluates at the backward's FD stencil, and the
// ones K3 marches on, are the very min-fold K1 evaluated in the forward,
// bitwise, when all are built without FMA contraction.  Each kernel is its
// own library of one translation unit, so the definitions sit in an
// anonymous namespace.

#pragma once

#include <cuda_runtime.h>

#include <limits>

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();

// scene.csg.PrimType codes of the dense leaves
constexpr int kSphere = 0;
constexpr int kBox = 1;
constexpr int kCross = 2;

// What the scene fold reads: passed by value, so it lives in registers.
struct Scene {
  const float4* tbl;    // [P][2]: (cx, cy, cz, ax), (ay, az, 0, 0)
  const int4* groups;   // [G]: gsign, first run, number of runs, cullable
  const int4* runs;     // [N]: prim type, first leaf, leaf count, scale
  int n_groups;
  int root_min;         // 1 when the root folds with MIN, else 0 (MAX)
};

__device__ __forceinline__ float med3(float a, float b, float c) {
  return fmaxf(fminf(a, b), fminf(fmaxf(a, b), c));
}

template <int kType>
__device__ __forceinline__ float leaf_sd(const float4* tbl, int i, float px,
                                         float py, float pz) {
  const float4 a = __ldg(tbl + 2 * i);
  if (kType == kSphere) {
    const float dx = px - a.x, dy = py - a.y, dz = pz - a.z;
    return sqrtf(dx * dx + dy * dy + dz * dz) - a.w;
  }
  const float4 b = __ldg(tbl + 2 * i + 1);
  const float bx = fabsf(px - a.x) - a.w * 0.5f;
  const float by = fabsf(py - a.y) - b.x * 0.5f;
  const float bz = fabsf(pz - a.z) - b.y * 0.5f;
  if (kType == kBox) return fmaxf(fmaxf(bx, by), bz);
  return med3(bx, by, bz);
}

// min over one run of scale * leaf sd, from acc.
template <int kType>
__device__ __forceinline__ float fold_span(const float4* tbl, int4 run,
                                           float px, float py, float pz,
                                           float acc) {
  const float scale = static_cast<float>(run.w);
  for (int i = run.y; i < run.y + run.z; ++i)
    acc = fminf(acc, scale * leaf_sd<kType>(tbl, i, px, py, pz));
  return acc;
}

__device__ __forceinline__ float fold_run(const float4* tbl, int4 run,
                                          float px, float py, float pz,
                                          float acc) {
  switch (run.x) {
    case kSphere: return fold_span<kSphere>(tbl, run, px, py, pz, acc);
    case kBox: return fold_span<kBox>(tbl, run, px, py, pz, acc);
    default: return fold_span<kCross>(tbl, run, px, py, pz, acc);
  }
}

struct Winner {
  float sd;
  int idx;
};

// (min, first argmin) over one run: strict < keeps the earliest leaf
// (body.cpp:12-14 first-wins ties).
template <int kType>
__device__ __forceinline__ Winner fold_span_idx(const float4* tbl, int4 run,
                                                float px, float py, float pz,
                                                Winner acc) {
  const float scale = static_cast<float>(run.w);
  for (int i = run.y; i < run.y + run.z; ++i) {
    const float sd = scale * leaf_sd<kType>(tbl, i, px, py, pz);
    if (sd < acc.sd) acc = Winner{sd, i};
  }
  return acc;
}

__device__ __forceinline__ Winner fold_run_idx(const float4* tbl, int4 run,
                                               float px, float py, float pz,
                                               Winner acc) {
  switch (run.x) {
    case kSphere: return fold_span_idx<kSphere>(tbl, run, px, py, pz, acc);
    case kBox: return fold_span_idx<kBox>(tbl, run, px, py, pz, acc);
    default: return fold_span_idx<kCross>(tbl, run, px, py, pz, acc);
  }
}

// Scene SDF: the two-level fold of pallas_march._scene_sd_tile over the
// plain leaf runs.  A cullable (DIFFERENCE) group first folds its base runs
// (scale -1, always leading); its value max(base, -carve...) is at least
// -gmin of the base, so when that bound already reaches the running scene
// minimum the carve cannot change the result and is skipped (per lane:
// exact).
__device__ __noinline__ float scene_sd(Scene s, float px, float py,
                                       float pz) {
  const float rsign = s.root_min ? 1.0f : -1.0f;
  float running = kInf;
  for (int gi = 0; gi < s.n_groups; ++gi) {
    const int4 g = __ldg(s.groups + gi);
    const int end = g.y + g.z;
    int k = g.y;
    float gmin = kInf;
    if (g.w) {
      for (; k < end; ++k) {
        const int4 run = __ldg(s.runs + k);
        if (run.w != -1) break;
        gmin = fold_run(s.tbl, run, px, py, pz, gmin);
      }
      if (-gmin >= running) continue;
    }
    for (; k < end; ++k)
      gmin = fold_run(s.tbl, __ldg(s.runs + k), px, py, pz, gmin);
    running = fminf(running, rsign * (static_cast<float>(g.x) * gmin));
  }
  return rsign * running;
}

// Scene SDF and colour winner leaf (-1: none), pallas_march
// ._scene_sd_idx_tile: strict < at every level, the same exact cull (a
// culled group's value is >= the running minimum, so it cannot win).
__device__ __noinline__ Winner scene_sd_idx(Scene s, float px, float py,
                                            float pz) {
  const float rsign = s.root_min ? 1.0f : -1.0f;
  Winner root{kInf, -1};
  for (int gi = 0; gi < s.n_groups; ++gi) {
    const int4 g = __ldg(s.groups + gi);
    const int end = g.y + g.z;
    int k = g.y;
    Winner w{kInf, -1};
    if (g.w) {
      for (; k < end; ++k) {
        const int4 run = __ldg(s.runs + k);
        if (run.w != -1) break;
        w = fold_run_idx(s.tbl, run, px, py, pz, w);
      }
      if (-w.sd >= root.sd) continue;
    }
    for (; k < end; ++k)
      w = fold_run_idx(s.tbl, __ldg(s.runs + k), px, py, pz, w);
    const float v = rsign * (static_cast<float>(g.x) * w.sd);
    if (v < root.sd) root = Winner{v, w.idx};
  }
  return Winner{rsign * root.sd, root.idx};
}

}  // namespace
