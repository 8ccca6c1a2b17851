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
//
// The value fold takes a Menger group's carve through the exact lattice
// collapse (pallas_march._menger_carve_lattice) while the wrapper's flag
// says the live rows still share the lattice's coordinates: per level a
// few axis excesses, one minimum per distinct x-set and one median per
// (y, z) column instead of every cross.  Only abs, subtract, exact
// halving, min and max: the same bits as the leaf fold.  The winner fold
// stays leaf by leaf.
//
// The scene is read through one of two views.  DeviceScene reads the
// wrapper's tensors through the read-only cache.  SharedScene reads a copy
// that persist.cuh staged once in the block's shared memory, for scenes
// that fit there: its box and cross sizes are already halved (exact) and
// its collapse stream already names coordinates instead of rows, so a
// column costs two loads, not two dependent pairs.

#pragma once

#include <cuda_runtime.h>

#include <limits>

// The block's dynamic shared memory: a staged scene first, then whatever
// the kernel keeps per warp.
extern __shared__ __align__(16) unsigned char rt_smem[];

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();

// scene.csg.PrimType codes of the dense leaves
constexpr int kSphere = 0;
constexpr int kBox = 1;
constexpr int kCross = 2;

// The scene as a C entry point receives it (tables.SceneOperands.args).
struct SceneArgs {
  const float4* tbl;     // [P][2]: (cx, cy, cz, ax), (ay, az, 0, 0)
  const int4* groups;    // [G]: gsign, first run, number of runs, cullable
  const int4* runs;      // [N]: prim type, first leaf, leaf count, scale
  const int* lat;        // collapse stream (tables.PackedPlan.lattice)
  const int* lat_flag;   // [1]: 1 while the collapse may be taken
  const float4* lights;  // [L][2]: (x, y, z, 0), (r, g, b, 0); may be null
  int n_rows, n_groups, n_runs, n_lat, n_lights;
  int root_min;          // 1 when the root folds with MIN, else 0 (MAX)
};

// The scene in device memory, read through the read-only cache.
struct DeviceScene {
  static constexpr bool kStaged = false;
  const float4* tbl;
  const int4* groups;
  const int4* runs;
  const int* lat;
  const float4* lights;
  int n_groups, root_min;
  bool collapse;

  __device__ __forceinline__ float4 row(int i) const { return __ldg(tbl + i); }
  __device__ __forceinline__ float coord(int i) const {
    return __ldg(reinterpret_cast<const float*>(tbl) + i);
  }
  __device__ __forceinline__ int4 group(int i) const {
    return __ldg(groups + i);
  }
  __device__ __forceinline__ int4 run(int i) const { return __ldg(runs + i); }
  __device__ __forceinline__ int stream(int i) const { return __ldg(lat + i); }
  __device__ __forceinline__ float4 light(int i) const {
    return __ldg(lights + i);
  }
};

// The scene staged in the block's shared memory: byte offsets into rt_smem,
// so every read compiles to a shared-memory load.
struct SharedScene {
  static constexpr bool kStaged = true;   // sizes halved, stream resolved
  unsigned tbl, groups, runs, lat, lights;
  int n_groups, root_min;
  bool collapse;

  __device__ __forceinline__ float4 row(int i) const {
    return reinterpret_cast<const float4*>(rt_smem + tbl)[i];
  }
  __device__ __forceinline__ float coord(int i) const {
    return reinterpret_cast<const float*>(rt_smem + tbl)[i];
  }
  __device__ __forceinline__ int4 group(int i) const {
    return reinterpret_cast<const int4*>(rt_smem + groups)[i];
  }
  __device__ __forceinline__ int4 run(int i) const {
    return reinterpret_cast<const int4*>(rt_smem + runs)[i];
  }
  __device__ __forceinline__ int stream(int i) const {
    return reinterpret_cast<const int*>(rt_smem + lat)[i];
  }
  __device__ __forceinline__ float4 light(int i) const {
    return reinterpret_cast<const float4*>(rt_smem + lights)[i];
  }
};

// SceneArgs from a C entry point's leading arguments.
inline SceneArgs scene_args(const void* tbl, const void* groups,
                            const void* runs, const void* lat,
                            const void* lat_flag, const void* lights,
                            int n_rows, int n_groups, int n_runs, int n_lat,
                            int n_lights, int root_min) {
  return SceneArgs{static_cast<const float4*>(tbl),
                   static_cast<const int4*>(groups),
                   static_cast<const int4*>(runs),
                   static_cast<const int*>(lat),
                   static_cast<const int*>(lat_flag),
                   static_cast<const float4*>(lights),
                   n_rows, n_groups, n_runs, n_lat, n_lights, root_min};
}

// The device-memory view of `a`; the collapse flag is read once here.
__device__ __forceinline__ DeviceScene device_scene(const SceneArgs& a) {
  return DeviceScene{a.tbl,      a.groups,   a.runs, a.lat, a.lights,
                     a.n_groups, a.root_min, __ldg(a.lat_flag) != 0};
}

__device__ __forceinline__ float med3(float a, float b, float c) {
  return fmaxf(fminf(a, b), fminf(fmaxf(a, b), c));
}

// Half the size of box or cross row i: halved here, or when it was staged.
template <class S>
__device__ __forceinline__ float3 half_size(const S& s, int i) {
  const float ax = s.coord(8 * i + 3), ay = s.coord(8 * i + 4),
              az = s.coord(8 * i + 5);
  if (S::kStaged) return make_float3(ax, ay, az);
  return make_float3(ax * 0.5f, ay * 0.5f, az * 0.5f);
}

template <int kType, class S>
__device__ __forceinline__ float leaf_sd(const S& s, int i, float px, float py,
                                         float pz) {
  const float4 a = s.row(2 * i);
  if (kType == kSphere) {
    const float dx = px - a.x, dy = py - a.y, dz = pz - a.z;
    return sqrtf(dx * dx + dy * dy + dz * dz) - a.w;
  }
  const float4 b = s.row(2 * i + 1);
  const float hx = S::kStaged ? a.w : a.w * 0.5f;
  const float hy = S::kStaged ? b.x : b.x * 0.5f;
  const float hz = S::kStaged ? b.y : b.y * 0.5f;
  const float bx = fabsf(px - a.x) - hx;
  const float by = fabsf(py - a.y) - hy;
  const float bz = fabsf(pz - a.z) - hz;
  if (kType == kBox) return fmaxf(fmaxf(bx, by), bz);
  return med3(bx, by, bz);
}

// min over one run of scale * leaf sd, from acc.
template <int kType, class S>
__device__ __forceinline__ float fold_span(const S& s, int4 run, float px,
                                           float py, float pz, float acc) {
  const float scale = static_cast<float>(run.w);
  for (int i = run.y; i < run.y + run.z; ++i)
    acc = fminf(acc, scale * leaf_sd<kType>(s, i, px, py, pz));
  return acc;
}

template <class S>
__device__ __forceinline__ float fold_run(const S& s, int4 run, float px,
                                          float py, float pz, float acc) {
  switch (run.x) {
    case kSphere: return fold_span<kSphere>(s, run, px, py, pz, acc);
    case kBox: return fold_span<kBox>(s, run, px, py, pz, acc);
    default: return fold_span<kCross>(s, run, px, py, pz, acc);
  }
}

struct Winner {
  float sd;
  int idx;
};

// (min, first argmin) over one run: strict < keeps the earliest leaf
// (body.cpp:12-14 first-wins ties).
template <int kType, class S>
__device__ __forceinline__ Winner fold_span_idx(const S& s, int4 run, float px,
                                                float py, float pz,
                                                Winner acc) {
  const float scale = static_cast<float>(run.w);
  for (int i = run.y; i < run.y + run.z; ++i) {
    const float sd = scale * leaf_sd<kType>(s, i, px, py, pz);
    if (sd < acc.sd) acc = Winner{sd, i};
  }
  return acc;
}

template <class S>
__device__ __forceinline__ Winner fold_run_idx(const S& s, int4 run, float px,
                                               float py, float pz,
                                               Winner acc) {
  switch (run.x) {
    case kSphere: return fold_span_idx<kSphere>(s, run, px, py, pz, acc);
    case kBox: return fold_span_idx<kBox>(s, run, px, py, pz, acc);
    default: return fold_span_idx<kCross>(s, run, px, py, pz, acc);
  }
}

// The centre coordinate on axis kAxis that stream entry i names: the
// entry is a representative row, or, in a staged scene, the coordinate
// itself (persist.cuh resolved it against the live rows).
template <int kAxis, class S>
__device__ __forceinline__ float stream_coord(const S& s, int i) {
  const int entry = s.stream(i);
  if (S::kStaged) return __int_as_float(entry);
  return s.coord(8 * entry + kAxis);
}

// The cross SDF of the column whose y and z entries are at stream offset
// i, given its x-set's least x excess a.
template <class S>
__device__ __forceinline__ float column_sd(const S& s, int i, float a,
                                           float py, float pz, float3 h) {
  const float by = fabsf(py - stream_coord<1>(s, i)) - h.y;
  const float bz = fabsf(pz - stream_coord<2>(s, i + 1)) - h.z;
  return med3(a, by, bz);
}

// min over the carve crosses of the group whose collapse block starts at
// stream offset `off` (tables.PackedPlan.lattice has the layout).  Within a
// level every cross shares per-axis centre coordinates and one size, so an
// axis excess |p - c| - h takes few distinct values, each read from a
// representative row.  The cross SDF, a median, is monotone in each excess
// and a min returns one of its inputs, so the min over a (y, z) column is
// the median of the column's least x excess with its y and z excess:
// bitwise the leaf fold's value, in any order (an excess is never -0 or
// NaN).  Columns that share an x-set share its minimum.  Every lane walks
// the same stream entries at the same time, so the reads broadcast.  The
// columns fold into four running minima, merged at the end: a ray that
// marches alone (the last of a launch) waits on each dependent chain, and
// four short chains take a quarter of the time of one long one.
template <class S>
__device__ __forceinline__ float lattice_carve(const S& s, int off, float px,
                                               float py, float pz) {
  float b0 = kInf, b1 = kInf, b2 = kInf, b3 = kInf;
  const int n_levels = s.stream(off++);
  for (int lv = 0; lv < n_levels; ++lv) {
    const int n_xsets = s.stream(off), size_row = s.stream(off + 1);
    off += 2;
    if (n_xsets == 0) {   // a level of one cross
      b0 = fminf(b0, leaf_sd<kCross>(s, size_row, px, py, pz));
      continue;
    }
    const float3 h = half_size(s, size_row);
    for (int xs = 0; xs < n_xsets; ++xs) {
      const int n_members = s.stream(off), n_columns = s.stream(off + 1);
      off += 2;
      float a = kInf;
      for (int m = 0; m < n_members; ++m)
        a = fminf(a, fabsf(px - stream_coord<0>(s, off + m)) - h.x);
      off += n_members;
      const int end = off + 2 * n_columns;
      for (; off + 8 <= end; off += 8) {
        b0 = fminf(b0, column_sd(s, off, a, py, pz, h));
        b1 = fminf(b1, column_sd(s, off + 2, a, py, pz, h));
        b2 = fminf(b2, column_sd(s, off + 4, a, py, pz, h));
        b3 = fminf(b3, column_sd(s, off + 6, a, py, pz, h));
      }
      for (; off < end; off += 2)
        b0 = fminf(b0, column_sd(s, off, a, py, pz, h));
    }
  }
  return fminf(fminf(b0, b1), fminf(b2, b3));
}

// Scene SDF: the two-level fold of pallas_march._scene_sd_tile.  A cullable
// (DIFFERENCE) group first folds its base runs (scale -1, always leading);
// its value max(base, -carve...) is at least -gmin of the base, so when that
// bound already reaches the running scene minimum the carve cannot change
// the result and is skipped (per lane: exact).  A surviving lane folds the
// carve through the lattice collapse when the group has a block and the
// flag holds, else leaf by leaf.
template <class S>
__device__ __noinline__ float scene_sd(const S s, float px, float py,
                                       float pz) {
  const float rsign = s.root_min ? 1.0f : -1.0f;
  float running = kInf;
  for (int gi = 0; gi < s.n_groups; ++gi) {
    const int4 g = s.group(gi);
    const int end = g.y + g.z;
    int k = g.y;
    float gmin = kInf;
    if (g.w) {
      for (; k < end; ++k) {
        const int4 run = s.run(k);
        if (run.w != -1) break;
        gmin = fold_run(s, run, px, py, pz, gmin);
      }
      if (-gmin >= running) continue;
      const int block = s.collapse ? s.stream(gi) : 0;
      if (block != 0) {
        gmin = fminf(gmin, lattice_carve(s, block, px, py, pz));
        k = end;
      }
    }
    for (; k < end; ++k) gmin = fold_run(s, s.run(k), px, py, pz, gmin);
    running = fminf(running, rsign * (static_cast<float>(g.x) * gmin));
  }
  return rsign * running;
}

// Scene SDF and colour winner leaf (-1: none), pallas_march
// ._scene_sd_idx_tile: strict < at every level, the same exact cull (a
// culled group's value is >= the running minimum, so it cannot win).
// Leaf by leaf: a collapsed minimum does not say which cross gave it.
template <class S>
__device__ __noinline__ Winner scene_sd_idx(const S s, float px, float py,
                                            float pz) {
  const float rsign = s.root_min ? 1.0f : -1.0f;
  Winner root{kInf, -1};
  for (int gi = 0; gi < s.n_groups; ++gi) {
    const int4 g = s.group(gi);
    const int end = g.y + g.z;
    int k = g.y;
    Winner w{kInf, -1};
    if (g.w) {
      for (; k < end; ++k) {
        const int4 run = s.run(k);
        if (run.w != -1) break;
        w = fold_run_idx(s, run, px, py, pz, w);
      }
      if (-w.sd >= root.sd) continue;
    }
    for (; k < end; ++k) w = fold_run_idx(s, s.run(k), px, py, pz, w);
    const float v = rsign * (static_cast<float>(g.x) * w.sd);
    if (v < root.sd) root = Winner{v, w.idx};
  }
  return Winner{rsign * root.sd, root.idx};
}

}  // namespace
