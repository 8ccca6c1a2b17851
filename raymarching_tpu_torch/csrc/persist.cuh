// Persistent launches of all four kernels (render_kernel.cu,
// surface_kernel.cu, march_kernel.cu, shade_kernel.cu): a grid sized to the
// card, the scene staged once per block, and rays (K2: points or hits)
// handed out a warp at a time from a counter in device memory.
//
// A block lives for the whole launch, so what it stages is paid once and
// not once per 128 rays: the primitive rows (box and cross sizes halved
// once they are copied: exact, and one multiplication less per leaf and
// evaluation), the group and run descriptors, the collapse stream (its
// row entries replaced by the coordinates they name, so the fold reads a
// column's coordinates directly; the winner rows at each block's end stay
// rows) and the light rows.  The fold then reads them with shared-memory
// loads (fold.cuh's SharedScene).  A scene too large for that (the wrapper
// decides from its byte count) runs the same kernel's DeviceScene
// instantiation, which stages nothing.
//
// Each warp takes the next 32 consecutive rays from the counter when it
// has finished the last, so a warp that drew short rays goes on to more
// and no block waits on its slowest warp.  The wrapper zeroes the counter
// before the launch.

#pragma once

#include <cstdint>

#include "fold.cuh"

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr unsigned kWarp = 32u;
// Rays are indexed with 32 bits here; the counter runs a warp past the
// last ray for every warp of the grid.
constexpr int64_t kMaxRays = (int64_t{1} << 31) - (int64_t{1} << 24);

inline __host__ __device__ unsigned align16(unsigned n) {
  return (n + 15u) & ~15u;
}

// Bytes of rt_smem a staged scene takes (0 for the device-memory view).
template <class S>
inline unsigned staged_bytes(const SceneArgs& a) {
  if (!S::kStaged) return 0u;
  return 32u * a.n_rows + 16u * a.n_groups + 16u * a.n_runs +
         align16(4u * a.n_lat) + 32u * a.n_lights;
}

// The scene staged in the block's shared memory (see stage_scene).
__device__ __forceinline__ SharedScene stage_shared(const SceneArgs& a) {
  SharedScene s;
  s.tbl = 0u;
  s.groups = 32u * a.n_rows;
  s.runs = s.groups + 16u * a.n_groups;
  s.lat = s.runs + 16u * a.n_runs;
  s.lights = s.lat + align16(4u * a.n_lat);
  s.n_groups = a.n_groups;
  s.root_min = a.root_min;
  s.collapse = __ldg(a.lat_flag) != 0;
  const int t = threadIdx.x;
  float4* tbl = reinterpret_cast<float4*>(rt_smem + s.tbl);
  for (int i = t; i < 2 * a.n_rows; i += kThreads) tbl[i] = __ldg(a.tbl + i);
  int4* groups = reinterpret_cast<int4*>(rt_smem + s.groups);
  for (int i = t; i < a.n_groups; i += kThreads) groups[i] = __ldg(a.groups + i);
  int4* runs = reinterpret_cast<int4*>(rt_smem + s.runs);
  for (int i = t; i < a.n_runs; i += kThreads) runs[i] = __ldg(a.runs + i);
  int* lat = reinterpret_cast<int*>(rt_smem + s.lat);
  for (int i = t; i < a.n_lat; i += kThreads) lat[i] = __ldg(a.lat + i);
  float4* lights = reinterpret_cast<float4*>(rt_smem + s.lights);
  for (int i = t; i < 2 * a.n_lights; i += kThreads)
    lights[i] = __ldg(a.lights + i);
  __syncthreads();
  // halve the box and cross sizes in place; a sphere's radius stays
  for (int k = 0; k < a.n_runs; ++k) {
    const int4 run = runs[k];
    if (run.x == kSphere) continue;
    for (int i = run.y + t; i < run.y + run.z; i += kThreads) {
      tbl[2 * i].w *= 0.5f;
      tbl[2 * i + 1].x *= 0.5f;
      tbl[2 * i + 1].y *= 0.5f;
    }
  }
  // resolve the collapse stream against the rows: a member's entry becomes
  // its x coordinate, a column's entries its y and z (the headers and each
  // level's size row stay; every thread walks them, none writes them)
  const float* coord = reinterpret_cast<const float*>(rt_smem + s.tbl);
  for (int gi = 0; gi < a.n_groups; ++gi) {
    int off = lat[gi];
    if (off == 0) continue;
    const int n_levels = lat[off];
    off += 2;
    for (int lv = 0; lv < n_levels; ++lv) {
      const int n_xsets = lat[off];
      off += 2;
      for (int xs = 0; xs < n_xsets; ++xs) {
        const int n_members = lat[off], n_columns = lat[off + 1];
        off += 2;
        for (int m = t; m < n_members; m += kThreads)
          lat[off + m] = __float_as_int(coord[8 * lat[off + m]]);
        off += n_members;
        for (int c = t; c < 2 * n_columns; c += kThreads)
          lat[off + c] = __float_as_int(coord[8 * lat[off + c] + 1 + (c & 1)]);
        off += 2 * n_columns;
      }
    }
  }
  __syncthreads();
  return s;
}

// The block's view of the scene: every thread of the block calls it once,
// at the top of the kernel.  S is DeviceScene or SharedScene, or either
// under Fused<> (a fused group's carve run names no rows, so staging
// halves nothing of it).
template <class S>
__device__ __forceinline__ S stage_scene(const SceneArgs& a) {
  if constexpr (S::kStaged)
    return S(stage_shared(a));
  else
    return S(device_scene(a));
}

// The first of the warp's next 32 rays, or a value >= R when none is left;
// every lane of the warp calls it together.
__device__ __forceinline__ unsigned next_rays(unsigned* counter) {
  unsigned base = 0u;
  if ((threadIdx.x & 31u) == 0u) base = atomicAdd(counter, kWarp);
  return __shfl_sync(kFullMask, base, 0);
}

// How many blocks of `kernel` with `smem` bytes of dynamic shared memory
// an SM holds at once.  Raises the kernel's dynamic shared memory limit
// when `smem` needs it.  Returns a CUDA error code.
template <class Kernel>
inline int blocks_per_sm(Kernel kernel, unsigned smem, int* per_sm) {
  cudaError_t err = cudaSuccess;
  if (smem > 48u * 1024u) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (*per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  return 0;
}

// Blocks for a persistent launch of `kernel` with `smem` bytes of dynamic
// shared memory over R rays: as many as the card holds at once, and no
// more than the rays need.  Returns a CUDA error code.
template <class Kernel>
inline int persistent_blocks(Kernel kernel, unsigned smem, int64_t R,
                             unsigned* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int code = blocks_per_sm(kernel, smem, &per_sm);
  if (code != 0) return code;
  const int64_t fit = static_cast<int64_t>(sms) * per_sm;
  const int64_t need = (R + kThreads - 1) / kThreads;
  *blocks = static_cast<unsigned>(need < fit ? need : fit);
  return 0;
}

}  // namespace
