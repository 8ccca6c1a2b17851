// The scene fold shared by all four kernels: K1 (render_kernel.cu), K2
// (surface_kernel.cu), K3 (march_kernel.cu) and K4 (shade_kernel.cu).
//
// Leaf distances and the two-level kernel-form fold of
// pallas_march._scene_sd_tile / _scene_sd_idx_tile / _scene_sd_idx_grad_tile
// over the int32 group and run descriptors of tables.pack_plan.  Every
// kernel includes this one definition, so the SDs K2 evaluates at the
// backward's FD stencil, and the ones K3 marches on, are the very min-fold
// K1 evaluated in the forward, bitwise, when all are built without FMA
// contraction.  Each kernel is its own library of one translation unit, so
// the definitions sit in an anonymous namespace.
//
// Layout.  Three forms of one fold:
//   * scene_sd: the value at one point (the marches);
//   * scene_sd_n<N>: the value at N points in ONE walk of the groups, runs
//     and collapse stream (the six points of an FD normal, K2's seven, the
//     two shadow rays of a hit that march in lockstep): every descriptor
//     and row is loaded once and applied to N points, whose N min chains
//     are independent, so their latencies overlap;
//   * scene_sd_idx<W>: the value and the first-wins winner leaf.  W =
//     Winner is the colour winner and folds leaf by leaf, as
//     _scene_sd_idx_tile does; W = PathWinner also carries the winning
//     run's prim type and path sign, and takes a Menger group's carve
//     through lattice_carve_idx, as _scene_sd_idx_grad_tile does;
//     winner_grad then gives that winner's gradient, the analytic normal
//     (K2's combined and analytic modes, shade.cuh's analytic normal).
//
// Fused generators (RenderConfig.fused_generators; pallas_march's D6,
// _fused_carve and the fused branches of the four tile folds) are a
// compile-time property of the scene view: Fused<S> is S whose plan was
// packed with tables.pack_plan(kp, fused=True).  There a generator group's
// descriptor says kGroupFused, its runs are its base leaf alone, and the
// run after them describes its carve, which is computed from the base row
// (fused_carve): the space-folded Menger union of the sponge's crosses,
// O(levels) work, or the DeathStar's derived sphere.  The group's value is
// max(base, -carve); its colour winner is the base leaf; a carve that wins
// the PathWinner fold reports the extended winner id P + ordinal, and
// winner_grad gives its gradient (winner_carve_grad).  The plain views keep
// kFused false, so the exact entries compile without any of it.
//
// The value folds and the PathWinner fold take a Menger group's carve
// through the exact lattice collapse (pallas_march._menger_carve_lattice,
// _menger_carve_lattice_idx_grad) while the wrapper's flag says the live
// rows still share the lattice's coordinates: per level a few axis
// excesses, one minimum per distinct x-set and one median per (y, z)
// column instead of every cross.  Only abs, subtract, exact halving, min
// and max: the same bits as the leaf fold.
//
// What bounds it.  Not the instruction rate but the latency of one
// dependent chain: descriptor, row, excess, min.  The design's answers:
// the collapse (fewer links), the scene in shared memory (shorter links),
// four running minima in the one-point collapse and N points a walk
// (several chains in flight).
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
  static constexpr bool kFused = false;
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
  static constexpr bool kFused = false;
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

// A scene view whose plan has the fused packing: the same reads, and the
// folds take kGroupFused groups (kFused selects that code at compile time).
template <class S>
struct Fused : S {
  static constexpr bool kFused = true;
  __device__ __forceinline__ explicit Fused(const S& s) : S(s) {}
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

// A fused group's descriptor (the fourth field of its int4; 1 is an exact
// group that takes the base-bound cull, 0 one that does not).  Its runs are
// the base leaf alone; the run after them is its carve: (Menger levels, or
// 0 for the DeathStar's sphere; the base row; 0, so that it names no rows
// to persist.cuh's staging; the extended winner id P + ordinal).
constexpr int kGroupFused = 2;
// |PathWinner.tag| - 1 of a carve winner is kCarveTag + the carve run.
constexpr int kCarveTag = 3;

// The Menger base box's full size: a staged row holds it halved (exact).
template <class S>
__device__ __forceinline__ float base_size(const S& s, float4 a) {
  return S::kStaged ? 2.0f * a.w : a.w;
}

// One fold of a query coordinate into the nearest cell of the next level:
// q - clip(round(q / pitch), -1, 1) * pitch, rounding half to even as
// jnp.round does.
__device__ __forceinline__ float menger_fold(float q, float pitch) {
  const float cell = fminf(fmaxf(rintf(q / pitch), -1.0f), 1.0f);
  return q - cell * pitch;
}

// The carve of a fused group at p, from its base row alone
// (pallas_march._fused_carve): the DeathStar's sphere of the base radius
// centred 1.5 r along x from the base centre (_deathstar_carve), or the
// space-folded union of the sponge's crosses (_menger_carve): one cross a
// level, the query folded into the nearest cell between levels.  JAX's
// order of operations: pitch = s / 3, then pitch / 3 a level; the cross
// size of a level equals its pitch.
template <class S>
__device__ __forceinline__ float fused_carve(const S& s, int4 c, float px,
                                             float py, float pz) {
  const float4 a = s.row(2 * c.y);
  if (c.x == 0) {
    const float r = a.w;
    const float dx = px - (a.x + 1.5f * r), dy = py - a.y, dz = pz - a.z;
    return sqrtf(dx * dx + dy * dy + dz * dz) - r;
  }
  float qx = px - a.x, qy = py - a.y, qz = pz - a.z;
  float pitch = base_size(s, a) / 3.0f;
  float carve = kInf;
  for (int k = 0; k < c.x; ++k) {
    const float h = pitch * 0.5f;
    carve = fminf(carve, med3(fabsf(qx) - h, fabsf(qy) - h, fabsf(qz) - h));
    if (k + 1 < c.x) {
      qx = menger_fold(qx, pitch);
      qy = menger_fold(qy, pitch);
      qz = menger_fold(qz, pitch);
      pitch = pitch / 3.0f;
    }
  }
  return carve;
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
  static constexpr bool kPath = false;
  float sd;
  int idx;
};

// A winner that also says how its leaf reaches the scene value, for the
// winner's gradient: tag = (prim type + 1) * path sign, the path sign
// being scale inside a group and gsign * scale at the root.
struct PathWinner {
  static constexpr bool kPath = true;
  float sd;
  int idx;
  int tag;
};

template <class W>
__device__ __forceinline__ W make_winner(float sd, int idx, int tag);
template <>
__device__ __forceinline__ Winner make_winner<Winner>(float sd, int idx, int) {
  return Winner{sd, idx};
}
template <>
__device__ __forceinline__ PathWinner make_winner<PathWinner>(float sd,
                                                              int idx,
                                                              int tag) {
  return PathWinner{sd, idx, tag};
}

// The group's winner `w` as the root sees it: value v, tag times gsign.
__device__ __forceinline__ Winner at_root(Winner w, float v, int) {
  return Winner{v, w.idx};
}
__device__ __forceinline__ PathWinner at_root(PathWinner w, float v,
                                              int gsign) {
  return PathWinner{v, w.idx, w.tag * gsign};
}

// (min, first argmin) over one run: strict < keeps the earliest leaf
// (body.cpp:12-14 first-wins ties).
template <int kType, class W, class S>
__device__ __forceinline__ W fold_span_idx(const S& s, int4 run, float px,
                                           float py, float pz, W acc) {
  const float scale = static_cast<float>(run.w);
  for (int i = run.y; i < run.y + run.z; ++i) {
    const float sd = scale * leaf_sd<kType>(s, i, px, py, pz);
    if (sd < acc.sd) acc = make_winner<W>(sd, i, run.w * (kType + 1));
  }
  return acc;
}

template <class W, class S>
__device__ __forceinline__ W fold_run_idx(const S& s, int4 run, float px,
                                          float py, float pz, W acc) {
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
  const int n_levels = s.stream(off);
  off += 2;   // the second entry is the winner rows' offset
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

// lattice_carve with the winning cross's table row (pallas_march
// ._menger_carve_lattice_idx_grad): (min, row of the first cross in the
// stream's order that attains it).  The block's second entry is the offset
// of its winner rows, a region of the stream that staging leaves as rows:
// one row for a level of one cross, then per column, in the order the
// columns are walked, the row of the column's cross at each member of its
// x-set.  An x-set keeps its first minimal member (strict <), and a
// column's cross is the one at that member.  Columns fold into four
// running (minimum, row position) pairs; each sees its columns in stream
// order, so strict < keeps its first, and the four merge by (minimum,
// position): the first minimal cross of the whole stream, as one strict-<
// chain would find it.  The row is read once, at the end.  The value is
// lattice_carve's, bitwise; the winner may be another member of a tie
// class than the leaf fold's (coincident arms: identical fields).
template <class S>
__device__ __forceinline__ Winner lattice_carve_idx(const S& s, int off,
                                                    float px, float py,
                                                    float pz) {
  const int n_levels = s.stream(off);
  int roff = s.stream(off + 1);
  off += 2;
  float b0 = kInf, b1 = kInf, b2 = kInf, b3 = kInf;
  int r0 = roff, r1 = roff, r2 = roff, r3 = roff;
  for (int lv = 0; lv < n_levels; ++lv) {
    const int n_xsets = s.stream(off), size_row = s.stream(off + 1);
    off += 2;
    if (n_xsets == 0) {   // a level of one cross
      const float sd = leaf_sd<kCross>(s, size_row, px, py, pz);
      if (sd < b0) { b0 = sd; r0 = roff; }
      roff += 1;
      continue;
    }
    const float3 h = half_size(s, size_row);
    for (int xs = 0; xs < n_xsets; ++xs) {
      const int n_members = s.stream(off), n_columns = s.stream(off + 1);
      off += 2;
      float a = kInf;
      int m_min = 0;
      for (int m = 0; m < n_members; ++m) {
        const float e = fabsf(px - stream_coord<0>(s, off + m)) - h.x;
        if (e < a) { a = e; m_min = m; }
      }
      off += n_members;
      int r = roff + m_min;          // the first column's winner position
      roff += n_members * n_columns;
      const int end = off + 2 * n_columns;
      for (; off + 8 <= end; off += 8, r += 4 * n_members) {
        const float c0 = column_sd(s, off, a, py, pz, h);
        const float c1 = column_sd(s, off + 2, a, py, pz, h);
        const float c2 = column_sd(s, off + 4, a, py, pz, h);
        const float c3 = column_sd(s, off + 6, a, py, pz, h);
        if (c0 < b0) { b0 = c0; r0 = r; }
        if (c1 < b1) { b1 = c1; r1 = r + n_members; }
        if (c2 < b2) { b2 = c2; r2 = r + 2 * n_members; }
        if (c3 < b3) { b3 = c3; r3 = r + 3 * n_members; }
      }
      for (; off < end; off += 2, r += n_members) {
        const float c0 = column_sd(s, off, a, py, pz, h);
        if (c0 < b0) { b0 = c0; r0 = r; }
      }
    }
  }
  if (b1 < b0 || (b1 == b0 && r1 < r0)) { b0 = b1; r0 = r1; }
  if (b3 < b2 || (b3 == b2 && r3 < r2)) { b2 = b3; r2 = r3; }
  if (b2 < b0 || (b2 == b0 && r2 < r0)) { b0 = b2; r0 = r2; }
  return Winner{b0, s.stream(r0)};
}

// N points at once.  The arrays are indexed by unrolled loops only, so
// they live in registers.
template <int N>
struct Points {
  float x[N], y[N], z[N];
};

// acc[j] = min(acc[j], scale * leaf sd at point j) over one run: each row
// is loaded once for the N points.
template <int kType, int N, class S>
__device__ __forceinline__ void fold_span_n(const S& s, int4 run,
                                            const Points<N>& p,
                                            float (&acc)[N]) {
  const float scale = static_cast<float>(run.w);
  for (int i = run.y; i < run.y + run.z; ++i) {
    const float4 a = s.row(2 * i);
    if (kType == kSphere) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float dx = p.x[j] - a.x, dy = p.y[j] - a.y, dz = p.z[j] - a.z;
        acc[j] = fminf(acc[j],
                       scale * (sqrtf(dx * dx + dy * dy + dz * dz) - a.w));
      }
      continue;
    }
    const float4 b = s.row(2 * i + 1);
    const float hx = S::kStaged ? a.w : a.w * 0.5f;
    const float hy = S::kStaged ? b.x : b.x * 0.5f;
    const float hz = S::kStaged ? b.y : b.y * 0.5f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float bx = fabsf(p.x[j] - a.x) - hx;
      const float by = fabsf(p.y[j] - a.y) - hy;
      const float bz = fabsf(p.z[j] - a.z) - hz;
      const float sd =
          kType == kBox ? fmaxf(fmaxf(bx, by), bz) : med3(bx, by, bz);
      acc[j] = fminf(acc[j], scale * sd);
    }
  }
}

template <int N, class S>
__device__ __forceinline__ void fold_run_n(const S& s, int4 run,
                                           const Points<N>& p,
                                           float (&acc)[N]) {
  switch (run.x) {
    case kSphere: fold_span_n<kSphere>(s, run, p, acc); break;
    case kBox: fold_span_n<kBox>(s, run, p, acc); break;
    default: fold_span_n<kCross>(s, run, p, acc); break;
  }
}

// acc[j] = min(acc[j], lattice_carve at point j): one walk of the block,
// each coordinate loaded once.  One running minimum a point (the N points
// are the independent chains here); a min of these values gives the same
// bits in any order.
template <int N, class S>
__device__ __forceinline__ void lattice_carve_n(const S& s, int off,
                                                const Points<N>& p,
                                                float (&acc)[N]) {
  const int n_levels = s.stream(off);
  off += 2;
  for (int lv = 0; lv < n_levels; ++lv) {
    const int n_xsets = s.stream(off), size_row = s.stream(off + 1);
    off += 2;
    if (n_xsets == 0) {   // a level of one cross
      fold_span_n<kCross>(s, make_int4(kCross, size_row, 1, 1), p, acc);
      continue;
    }
    const float3 h = half_size(s, size_row);
    for (int xs = 0; xs < n_xsets; ++xs) {
      const int n_members = s.stream(off), n_columns = s.stream(off + 1);
      off += 2;
      float a[N];
#pragma unroll
      for (int j = 0; j < N; ++j) a[j] = kInf;
      for (int m = 0; m < n_members; ++m) {
        const float cx = stream_coord<0>(s, off + m);
#pragma unroll
        for (int j = 0; j < N; ++j)
          a[j] = fminf(a[j], fabsf(p.x[j] - cx) - h.x);
      }
      off += n_members;
      for (const int end = off + 2 * n_columns; off < end; off += 2) {
        const float cy = stream_coord<1>(s, off);
        const float cz = stream_coord<2>(s, off + 1);
#pragma unroll
        for (int j = 0; j < N; ++j)
          acc[j] = fminf(acc[j], med3(a[j], fabsf(p.y[j] - cy) - h.y,
                                      fabsf(p.z[j] - cz) - h.z));
      }
    }
  }
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
      if constexpr (S::kFused) {
        if (g.w == kGroupFused)
          gmin = fminf(gmin, fused_carve(s, s.run(end), px, py, pz));
      }
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

// scene_sd at the N points of `p` in one walk: out[j] is scene_sd's value
// at point j, bitwise.  Each descriptor, row and stream entry is loaded
// once for all N, and the N min chains are independent.  The DIFFERENCE
// cull becomes: skip the carve when every one of the N points may.  When
// some point needs it, all N fold it, and a point that could have skipped
// keeps its running minimum by a select instead of the min (the cull's
// proof says the min would return it; the select needs no proof, not even
// about the sign of a zero).
template <int N>
struct Fold {
  float v[N];
};

template <int N, class S>
__device__ __noinline__ Fold<N> scene_sd_n(const S s, const Points<N> p) {
  const float rsign = s.root_min ? 1.0f : -1.0f;
  float running[N];
#pragma unroll
  for (int j = 0; j < N; ++j) running[j] = kInf;
  for (int gi = 0; gi < s.n_groups; ++gi) {
    const int4 g = s.group(gi);
    const int end = g.y + g.z;
    int k = g.y;
    float gmin[N];
    bool keep[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      gmin[j] = kInf;
      keep[j] = true;
    }
    if (g.w) {
      for (; k < end; ++k) {
        const int4 run = s.run(k);
        if (run.w != -1) break;
        fold_run_n(s, run, p, gmin);
      }
      bool any = false;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        keep[j] = !(-gmin[j] >= running[j]);
        any = any || keep[j];
      }
      if (!any) continue;
      if constexpr (S::kFused) {
        if (g.w == kGroupFused) {
          const int4 c = s.run(end);
#pragma unroll
          for (int j = 0; j < N; ++j)
            gmin[j] = fminf(gmin[j],
                            fused_carve(s, c, p.x[j], p.y[j], p.z[j]));
        }
      }
      const int block = s.collapse ? s.stream(gi) : 0;
      if (block != 0) {
        lattice_carve_n(s, block, p, gmin);
        k = end;
      }
    }
    for (; k < end; ++k) fold_run_n(s, s.run(k), p, gmin);
    const float gs = static_cast<float>(g.x);
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (keep[j]) running[j] = fminf(running[j], rsign * (gs * gmin[j]));
  }
  Fold<N> out;
#pragma unroll
  for (int j = 0; j < N; ++j) out.v[j] = rsign * running[j];
  return out;
}

// Scene SDF and winner leaf (-1: none), pallas_march._scene_sd_idx_tile
// (W = Winner) and the value and winner of _scene_sd_idx_grad_tile (W =
// PathWinner): strict < at every level, the same exact cull (a culled
// group's value is >= the running minimum, so it cannot win).  The colour
// winner folds leaf by leaf; a fused group's is its base leaf, and its
// PathWinner the base or the carve's extended id.  The PathWinner fold takes a collapsing
// group's carve through lattice_carve_idx while the flag holds; the base
// leaves are earlier in the table, so they win ties with the carve.
template <class W, class S>
__device__ __noinline__ W scene_sd_idx(const S s, float px, float py,
                                       float pz) {
  const float rsign = s.root_min ? 1.0f : -1.0f;
  W root = make_winner<W>(kInf, -1, 0);
  for (int gi = 0; gi < s.n_groups; ++gi) {
    const int4 g = s.group(gi);
    const int end = g.y + g.z;
    int k = g.y;
    W w = make_winner<W>(kInf, -1, 0);
    if (g.w) {
      for (; k < end; ++k) {
        const int4 run = s.run(k);
        if (run.w != -1) break;
        w = fold_run_idx(s, run, px, py, pz, w);
      }
      if (-w.sd >= root.sd) continue;
      if constexpr (S::kFused) {
        if (g.w == kGroupFused) {
          // the base wins ties (take_base = base >= -carve); the colour
          // winner stays the base leaf, the PathWinner names the carve
          const int4 c = s.run(end);
          const float cv = fused_carve(s, c, px, py, pz);
          if (cv < w.sd) {
            if constexpr (W::kPath)
              w = make_winner<W>(cv, c.w, kCarveTag + 1 + end);
            else
              w.sd = cv;
          }
        }
      }
      const int block = W::kPath && s.collapse ? s.stream(gi) : 0;
      if (block != 0) {
        const Winner c = lattice_carve_idx(s, block, px, py, pz);
        if (c.sd < w.sd) w = make_winner<W>(c.sd, c.idx, kCross + 1);
        k = end;
      }
    }
    for (; k < end; ++k) w = fold_run_idx(s, s.run(k), px, py, pz, w);
    const float v = rsign * (static_cast<float>(g.x) * w.sd);
    if (v < root.sd) root = at_root(w, v, g.x);
  }
  root.sd = rsign * root.sd;
  return root;
}

// The winner's gradient, d scene / dp = gsign * scale * d leaf / dp, as
// _scene_sd_idx_grad_tile folds it: only the winner's gradient survives
// the fold's selects and sign flips are exact, so the gradient of the
// scene_sd_idx<PathWinner> winner, evaluated once, is the fold's.  K2's
// combined and analytic modes and the analytic normal of shade.cuh.

__device__ __forceinline__ float sgn(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
}

// d leaf sd / dp of leaf i of prim type `type` (pallas_march._prim_sd_grad):
// sphere (p - c) / max(|p - c|, 1e-30); box one-hot sign on the first
// argmax axis (ties to x, then y); cross one-hot sign on the median axis.
template <class S>
__device__ float3 leaf_grad(const S& s, int type, int i, float px, float py,
                            float pz) {
  const float4 a = s.row(2 * i);
  const float dx = px - a.x, dy = py - a.y, dz = pz - a.z;
  if (type == kSphere) {
    const float r = sqrtf(dx * dx + dy * dy + dz * dz);
    const float inv = 1.0f / fmaxf(r, 1e-30f);
    return make_float3(dx * inv, dy * inv, dz * inv);
  }
  const float3 h = half_size(s, i);
  const float bx = fabsf(dx) - h.x;
  const float by = fabsf(dy) - h.y;
  const float bz = fabsf(dz) - h.z;
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

// d carve / dp of the fused carve whose run is c
// (pallas_march._fused_carve_grad): the DeathStar sphere's unit vector
// (_deathstar_carve_grad), or the winning level's cross gradient, which
// the folds (translations almost everywhere) pass through unchanged
// (_menger_carve_grad): the walk again, a later level winning only with
// strict <, the cross's one-hot sign on its median axis.
template <class S>
__device__ float3 winner_carve_grad(const S& s, int4 c, float px, float py,
                                    float pz) {
  const float4 a = s.row(2 * c.y);
  if (c.x == 0) {
    const float dx = px - (a.x + 1.5f * a.w), dy = py - a.y, dz = pz - a.z;
    const float d = sqrtf(dx * dx + dy * dy + dz * dz);
    const float inv = 1.0f / fmaxf(d, 1e-30f);
    return make_float3(dx * inv, dy * inv, dz * inv);
  }
  float qx = px - a.x, qy = py - a.y, qz = pz - a.z;
  float pitch = base_size(s, a) / 3.0f;
  float carve = kInf;
  float3 g = make_float3(0.0f, 0.0f, 0.0f);
  for (int k = 0; k < c.x; ++k) {
    const float h = pitch * 0.5f;
    const float bx = fabsf(qx) - h, by = fabsf(qy) - h, bz = fabsf(qz) - h;
    const float sd = med3(bx, by, bz);
    if (sd < carve) {
      carve = sd;
      const bool max_x = bx >= fmaxf(by, bz);
      const bool max_y = !max_x && by >= bz;
      const bool min_x = bx <= fminf(by, bz);
      const bool min_y = !min_x && by <= bz;
      const bool med_x = !(max_x || min_x);
      const bool med_y = !(max_y || min_y || med_x);
      const bool med_z = !(med_x || med_y);
      g = make_float3(med_x ? sgn(qx) : 0.0f, med_y ? sgn(qy) : 0.0f,
                      med_z ? sgn(qz) : 0.0f);
    }
    if (k + 1 < c.x) {
      qx = menger_fold(qx, pitch);
      qy = menger_fold(qy, pitch);
      qz = menger_fold(qz, pitch);
      pitch = pitch / 3.0f;
    }
  }
  return g;
}

// The winner's gradient: its tag gives the prim type (or, past kCross, the
// run of a fused carve) and the path sign gsign * scale (the root's rsign
// cancels in the chain rule; a carve's is -1: the group is max(base,
// -carve)).
template <class S>
__device__ __forceinline__ float3 winner_grad(const S& s, PathWinner w,
                                              float px, float py, float pz) {
  if (w.idx < 0) return make_float3(0.0f, 0.0f, 0.0f);
  const float path = w.tag < 0 ? -1.0f : 1.0f;
  const int type = abs(w.tag) - 1;
  float3 lg;
  if constexpr (S::kFused) {
    lg = type > kCross
             ? winner_carve_grad(s, s.run(type - kCarveTag), px, py, pz)
             : leaf_grad(s, type, w.idx, px, py, pz);
  } else {
    lg = leaf_grad(s, type, w.idx, px, py, pz);
  }
  return make_float3(path * lg.x, path * lg.y, path * lg.z);
}

}  // namespace
