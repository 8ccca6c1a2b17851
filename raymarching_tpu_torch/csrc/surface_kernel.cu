// K2: the scene evaluated at given points, in five modes.
//
// Replaces raymarching_tpu/ops/pallas_march.py::_surface_kernel (the
// pallas_call in _compiled_surface_call; entry pallas_surface_eval), on
// exact tables or with fused generators (JAX's fused=True: the scene view
// Fused<S>, fold.cuh; an instantiation each), in five modes:
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
//     multi-kernel backend's normals;
//   * analytic (with_normal, analytic): the SD and the winner's gradient,
//     no winner: the multi-kernel backend's analytic normals.  The
//     combined mode's fold without its winner store, so its SD and
//     gradient are the combined mode's, bitwise.
// With fused generators a carve that wins the combined fold reports the
// extended winner id P + ordinal (_scene_sd_idx_grad_tile), and the winner
// mode a generator's base leaf.  Its plain PyTorch twin is
// raymarching_tpu_torch/ops/surface_kernel.py::surface_eval_plain.
//
// Layout.  K1's: a persistent grid (persist.cuh), the scene staged in each
// block's shared memory when it fits (menger4 does not: it runs the
// device-memory instantiation of the same kernel), each warp taking 32
// consecutive work items at a time from a counter, one thread an item.
// Two entries share the kernel.  rt_surface_eval: an item is a point of
// q [3][N].  rt_surface_stencil (combined mode): an item is a hit of
// p [3][R], and its thread evaluates the hit's FD stencil, K = 7 points
// with the centre or 6 without, making each point in registers (p + h and
// p - h: the additions the plain twin makes) and writing row k of the
// outputs, so the stencil points never exist in device memory.  Inputs and
// outputs are structure-of-arrays rows, so loads and stores coalesce; at
// each of a thread's K evaluations its warp holds 32 neighbouring hits at
// one offset, so the fold's culls stay coherent.
//
// Design.  The JAX kernel carries the gradient through every select of the
// fold.  Only the winner's gradient survives, and sign flips are exact, so
// this kernel folds (sd, winner, the winning run's prim type and path
// sign) and then evaluates the gradient of the winning leaf alone
// (fold.cuh's winner_grad): the same bits, for one leaf gradient per point
// instead of one per leaf.  In the combined and analytic modes a Menger
// group's carve goes through the lattice collapse with winner rows
// (fold.cuh's lattice_carve_idx), as the JAX kernel's does; the winner
// mode is the colour winner and folds leaf by leaf.  The fd mode evaluates
// its seven points in one walk of the scene (scene_sd_n<7>), or with
// `multipoint` off in seven.
//
// What bounds it.  The combined mode on the backward's stencils: bytes
// (12 read a hit and 20 written a stencil point, against a fold the cull
// keeps short).  The other modes: the latency of the fold's dependent
// chain (descriptor, row, min) ahead of the instruction rate, as K1.  No
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

#include "persist.cuh"

namespace {

// ops/surface_kernel.py's mode codes
constexpr int kCombined = 0;
constexpr int kSdOnly = 1;
constexpr int kWinner = 2;
constexpr int kFdGrad = 3;
constexpr int kAnalytic = 4;

struct SurfaceParams {
  SceneArgs scene;
  const float* q;       // [3][n]: the points, or the hits of a stencil
  float* out;           // [4][M] (sd, gx, gy, gz) in the combined, fd and
                        // analytic modes, else [1][M]; M = n, or K n for a
                        // stencil
  int* widx;            // [M] in the combined and winner modes
  unsigned* counter;    // [1]: the next item to hand out, zero at launch
  float h, inv_2h;      // the fd mode's and the stencil's offset; 1 / 2h
  int center;           // a stencil's K: 7 with the centre, else 6
  int multipoint;       // the fd mode's seven points in one walk
  unsigned n;
};

// sd, winner and winner gradient at one point, written to column m of M.
template <class S>
__device__ __forceinline__ void combined_at(const S& s,
                                            const SurfaceParams& P, float px,
                                            float py, float pz, size_t m,
                                            size_t M) {
  const PathWinner w = scene_sd_idx<PathWinner>(s, px, py, pz);
  const float3 g = winner_grad(s, w, px, py, pz);
  P.out[m] = w.sd;
  P.widx[m] = w.idx;
  P.out[M + m] = g.x;
  P.out[2 * M + m] = g.y;
  P.out[3 * M + m] = g.z;
}

template <int kMode, bool kStencil, class S>
__global__ void __launch_bounds__(kThreads)
    surface_kernel(const SurfaceParams P) {
  const S s = stage_scene<S>(P.scene);
  const size_t n = P.n;
  const float h = P.h;
  for (;;) {
    const unsigned base = next_rays(P.counter);
    if (base >= P.n) break;
    const size_t i = base + (threadIdx.x & 31u);
    if (i >= n) continue;
    const float px = P.q[i], py = P.q[n + i], pz = P.q[2 * n + i];
    if (kStencil) {
      // scene_vjp.stencil_points' rows: the centre, then +x +y +z -x -y -z
      const size_t K = P.center ? 7 : 6, M = K * n;
      size_t m = i;
      if (P.center) {
        combined_at(s, P, px, py, pz, m, M);
        m += n;
      }
      for (int k = 0; k < 6; ++k, m += n) {
        const float d = k < 3 ? h : -h;
        const int a = k % 3;
        combined_at(s, P, a == 0 ? px + d : px, a == 1 ? py + d : py,
                    a == 2 ? pz + d : pz, m, M);
      }
    } else if (kMode == kCombined) {
      combined_at(s, P, px, py, pz, i, n);
    } else if (kMode == kWinner) {
      const Winner w = scene_sd_idx<Winner>(s, px, py, pz);
      P.out[i] = w.sd;
      P.widx[i] = w.idx;
    } else if (kMode == kSdOnly) {
      P.out[i] = scene_sd(s, px, py, pz);
    } else if (kMode == kAnalytic) {
      const PathWinner w = scene_sd_idx<PathWinner>(s, px, py, pz);
      const float3 g = winner_grad(s, w, px, py, pz);
      P.out[i] = w.sd;
      P.out[n + i] = g.x;
      P.out[2 * n + i] = g.y;
      P.out[3 * n + i] = g.z;
    } else {
      // pallas_march._surface_kernel's order of operations: the difference
      // first, then one multiplication by 1 / 2h
      float sd, gx, gy, gz;
      if (P.multipoint) {
        const Fold<7> f = scene_sd_n<7>(
            s, Points<7>{{px, px + h, px - h, px, px, px, px},
                         {py, py, py, py + h, py - h, py, py},
                         {pz, pz, pz, pz, pz, pz + h, pz - h}});
        sd = f.v[0];
        gx = f.v[1] - f.v[2];
        gy = f.v[3] - f.v[4];
        gz = f.v[5] - f.v[6];
      } else {
        sd = scene_sd(s, px, py, pz);
        gx = scene_sd(s, px + h, py, pz) - scene_sd(s, px - h, py, pz);
        gy = scene_sd(s, px, py + h, pz) - scene_sd(s, px, py - h, pz);
        gz = scene_sd(s, px, py, pz + h) - scene_sd(s, px, py, pz - h);
      }
      P.out[i] = sd;
      P.out[n + i] = gx * P.inv_2h;
      P.out[2 * n + i] = gy * P.inv_2h;
      P.out[3 * n + i] = gz * P.inv_2h;
    }
  }
}

template <int kMode, bool kStencil, class S>
int launch(const SurfaceParams& P, cudaStream_t stream) {
  const unsigned smem = staged_bytes<S>(P.scene);
  unsigned blocks = 0;
  const int err = persistent_blocks(surface_kernel<kMode, kStencil, S>, smem,
                                    P.n, &blocks);
  if (err != 0) return err;
  surface_kernel<kMode, kStencil, S><<<blocks, kThreads, smem, stream>>>(P);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode, bool kStencil>
int launch_view(const SurfaceParams& P, int shared, int fused,
                cudaStream_t stream) {
  if (fused)
    return shared ? launch<kMode, kStencil, Fused<SharedScene>>(P, stream)
                  : launch<kMode, kStencil, Fused<DeviceScene>>(P, stream);
  return shared ? launch<kMode, kStencil, SharedScene>(P, stream)
                : launch<kMode, kStencil, DeviceScene>(P, stream);
}

}  // namespace

// Launch K2 in `mode` on `stream` over N points q [3][N]; out [4][N] (sd,
// gx, gy, gz) in the combined, fd and analytic modes, else [1][N]; widx
// [N] in the combined and winner modes; the scene staged in shared memory
// (`shared` != 0) or read from device memory, the plan packed with fused
// generators (`fused` != 0) or exact; `counter` is one zeroed int32; h and
// inv_2h (= 1 / 2h, rounded by the caller) and `multipoint` are read in
// the fd mode only.  Returns a CUDA error code, cudaErrorInvalidValue for
// an unknown mode.
extern "C" int rt_surface_eval(const void* tbl, const void* groups,
                               const void* runs, const void* lat,
                               const void* lat_flag, int n_rows, int n_groups,
                               int n_runs, int n_lat, int root_min, int fused,
                               int shared, int mode, int multipoint, float h,
                               float inv_2h, const void* q, void* out,
                               void* widx, void* counter, int64_t N,
                               void* stream) {
  SurfaceParams P;
  P.scene = scene_args(tbl, groups, runs, lat, lat_flag, nullptr, n_rows,
                       n_groups, n_runs, n_lat, 0, root_min);
  P.q = static_cast<const float*>(q);
  P.out = static_cast<float*>(out);
  P.widx = static_cast<int*>(widx);
  P.counter = static_cast<unsigned*>(counter);
  P.h = h;
  P.inv_2h = inv_2h;
  P.center = 0;
  P.multipoint = multipoint;
  if (mode < kCombined || mode > kAnalytic || N < 0 || N > kMaxRays)
    return static_cast<int>(cudaErrorInvalidValue);
  P.n = static_cast<unsigned>(N);
  if (N == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kCombined: return launch_view<kCombined, false>(P, shared, fused, st);
    case kSdOnly: return launch_view<kSdOnly, false>(P, shared, fused, st);
    case kWinner: return launch_view<kWinner, false>(P, shared, fused, st);
    case kFdGrad: return launch_view<kFdGrad, false>(P, shared, fused, st);
    default: return launch_view<kAnalytic, false>(P, shared, fused, st);
  }
}

// Launch K2's combined mode on `stream` over the FD stencils of R hits
// p [3][R]: K = 7 rows with `center` (row 0 the hit, rows 1 + a and 4 + a
// the hit +- h on axis a), else 6 (rows a and 3 + a); out [4][K R], widx
// [K R], row k of hit i at column k R + i.  `shared` and `counter` as
// rt_surface_eval takes them; exact tables only (`fused` must be 0: the
// exact FD backward's entry).  Returns a CUDA error code.
extern "C" int rt_surface_stencil(const void* tbl, const void* groups,
                                  const void* runs, const void* lat,
                                  const void* lat_flag, int n_rows,
                                  int n_groups, int n_runs, int n_lat,
                                  int root_min, int fused, int shared,
                                  int center,
                                  float h, const void* p, void* out,
                                  void* widx, void* counter, int64_t R,
                                  void* stream) {
  SurfaceParams P;
  P.scene = scene_args(tbl, groups, runs, lat, lat_flag, nullptr, n_rows,
                       n_groups, n_runs, n_lat, 0, root_min);
  P.q = static_cast<const float*>(p);
  P.out = static_cast<float*>(out);
  P.widx = static_cast<int*>(widx);
  P.counter = static_cast<unsigned*>(counter);
  P.h = h;
  P.inv_2h = 0.0f;
  P.center = center;
  P.multipoint = 0;
  if (R < 0 || R > kMaxRays || fused != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  P.n = static_cast<unsigned>(R);
  if (R == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return shared ? launch<kCombined, true, SharedScene>(P, st)
                : launch<kCombined, true, DeviceScene>(P, st);
}

// Resident blocks an SM of the stencil entry's kernel (the one a training
// step launches) with `staged` bytes of scene in shared memory (`shared`
// != 0) or with the scene in device memory, for reports; negative: a CUDA
// error code.
extern "C" int rt_blocks_per_sm(int shared, int staged) {
  int per_sm = 0;
  const int err =
      shared ? blocks_per_sm(surface_kernel<kCombined, true, SharedScene>,
                             static_cast<unsigned>(staged), &per_sm)
             : blocks_per_sm(surface_kernel<kCombined, true, DeviceScene>, 0u,
                             &per_sm);
  return err != 0 ? -err : per_sm;
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
