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
// Layout.  A persistent grid (persist.cuh): as many blocks of 128 threads
// as the card holds at once; each stages the scene in its shared memory
// when it fits, then each warp marches 32 consecutive rays at a time, one
// thread per ray, taking the next 32 from a counter until none is left.
// Origins, directions, tmax in and the outputs out are structure-of-arrays
// rows of [R] float32 (int32 for the step count), so loads and stores
// coalesce.  The march and the fold are K1's own (march.cuh, fold.cuh).
// The evaluation cap is exactly `iterations`: the TPU kernel's blocked
// exit check and its table preload answer that machine's costs and are not
// carried over.
//
// What bounds it.  Operations, not bytes: a ray reads 24 to 28 bytes and
// writes 20 to 24, against the fold's work at every step, and within that
// the latency of a dependent chain (descriptor, row, min) more than the
// instruction rate.  The design answers with the lattice collapse (a
// Menger carve costs a seventh of its leaf fold), with the scene in shared
// memory (a row or descriptor read is a short-latency load that no other
// traffic evicts), and with warps that draw their own work.  The lanes of
// a warp still wait for its slowest ray: on the demo they are busy 87 to
// 90% of the time (chip_smoke.py's [warp] phase), so a finished lane does
// not take a new ray here.
//
// Exactness.  No fast math and no FMA contraction (the nvcc-flags line
// below), like K1: the kernel is bitwise equal to its twin and its hit
// points are K1's.  The distance along a shadow ray is the projection
// (p - o) . d, not the sum of steps, as in the TPU kernel.

// nvcc-flags: -fmad=false

#include <cuda_runtime.h>

#include <cstdint>

#include "march.cuh"
#include "persist.cuh"

namespace {

struct Params {
  SceneArgs scene;
  int iterations;
  float eps;
  const float* org;    // [3][R] per-ray origins, or null
  float ox, oy, oz;    // the shared origin when org is null
  const float* dirs;   // [3][R]
  const float* tmax;   // [R], or null: no distance limit
  float* out;          // [5][R]: px, py, pz, sd, done
  int* steps;          // [R], or null: no step count
  unsigned* counter;   // [1]: the next ray to hand out, zero at launch
  unsigned R;
};

template <class S>
__global__ void __launch_bounds__(kThreads) march_kernel(const Params P) {
  const S s = stage_scene<S>(P.scene);
  const unsigned R = P.R;
  const bool has_tmax = P.tmax != nullptr;
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
    const float tmax = has_tmax ? P.tmax[i] : 0.0f;
    const Hit hit = march(s, P.iterations, P.eps, ox, oy, oz, dx, dy, dz,
                          has_tmax, tmax, false);
    P.out[i] = hit.x;
    P.out[R + i] = hit.y;
    P.out[2 * R + i] = hit.z;
    P.out[3 * R + i] = hit.sd;
    P.out[4 * R + i] = hit.done ? 1.0f : 0.0f;
    if (P.steps != nullptr) P.steps[i] = hit.steps;
  }
}

template <class S>
int launch(const Params& P, cudaStream_t stream) {
  const unsigned smem = staged_bytes<S>(P.scene);
  unsigned blocks = 0;
  const int err = persistent_blocks(march_kernel<S>, smem, P.R, &blocks);
  if (err != 0) return err;
  march_kernel<S><<<blocks, kThreads, smem, stream>>>(P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch K3 on `stream` over R rays, the scene staged in shared memory
// (`shared` != 0) or read from device memory, the plan packed with fused
// generators (`fused` != 0) or exact; `counter` is one zeroed int32.
// Returns a CUDA error code.
extern "C" int rt_march_rays(const void* tbl, const void* groups,
                             const void* runs, const void* lat,
                             const void* lat_flag, int n_rows, int n_groups,
                             int n_runs, int n_lat, int root_min, int fused,
                             int shared,
                             int iterations, float eps, const void* org,
                             float ox, float oy, float oz, const void* dirs,
                             const void* tmax, void* out, void* steps,
                             void* counter, int64_t R, void* stream) {
  Params P;
  P.scene = scene_args(tbl, groups, runs, lat, lat_flag, nullptr, n_rows,
                       n_groups, n_runs, n_lat, 0, root_min);
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
  P.counter = static_cast<unsigned*>(counter);
  if (R < 0 || R > kMaxRays) return static_cast<int>(cudaErrorInvalidValue);
  P.R = static_cast<unsigned>(R);
  if (R == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fused)
    return shared ? launch<Fused<SharedScene>>(P, st)
                  : launch<Fused<DeviceScene>>(P, st);
  return shared ? launch<SharedScene>(P, st) : launch<DeviceScene>(P, st);
}

// Resident blocks an SM of this kernel with `staged` bytes of scene in
// shared memory (`shared` != 0) or with the scene in device memory, exact
// or fused (`fused` != 0), for reports; negative: a CUDA error code.
extern "C" int rt_blocks_per_sm(int shared, int staged, int fused) {
  int per_sm = 0;
  const unsigned smem = shared ? static_cast<unsigned>(staged) : 0u;
  const int err =
      fused ? (shared ? blocks_per_sm(march_kernel<Fused<SharedScene>>, smem,
                                      &per_sm)
                      : blocks_per_sm(march_kernel<Fused<DeviceScene>>, 0u,
                                      &per_sm))
            : (shared ? blocks_per_sm(march_kernel<SharedScene>, smem,
                                      &per_sm)
                      : blocks_per_sm(march_kernel<DeviceScene>, 0u,
                                      &per_sm));
  return err != 0 ? -err : per_sm;
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
