// The parameter scatter: segmented float64 sums of per-row terms onto the
// leaf rows, out[id[r], c] += term[r, c] for every row r whose id lies in
// [0, P); other ids (a miss's -1) are dropped.
//
// Replaces no TPU kernel.  The JAX package reduces with blocked one-hot
// matmuls on the MXU (scene_vjp._segment_add); on the card the port's
// backwards summed with index_add_ in float64, 7 atomics a row onto a few
// thousand addresses.  Adjacent rays hit the same few leaves, so those
// atomics piled onto a handful of L2 lines: 20 ms of the demo's fit step
// for 7,340,032 stencil rows.  Its plain PyTorch twin is
// raymarching_tpu_torch/ops/segment_kernel.py::segment_sum_plain (that
// index_add_, the CPU's path).
//
// What bounds it.  Bytes: the theta entry reads a row's winner id, its
// gradient and its cotangent (20 bytes) and nothing else, and writes only
// [P, C] float64 sums.  Its design keeps the atomics off that path:
//   * each warp takes 32 consecutive rows; the runs of equal ids among
//     them sum by a segmented shuffle reduction in float64 (five steps),
//     and runs of one id that lie apart in the warp are merged by their
//     heads (__match_any_sync), so each id adds once a warp;
//   * while P * C float64 sums fit one block's shared memory (the demo:
//     429 leaves x 7 columns, 24 KB) each block keeps them there, walks a
//     contiguous share of the rows (a patch of the image, which few leaves
//     cover) and at its end adds its non-zero sums to the output with the
//     native float64 atomicAdd.  Beyond that the warps' sums go straight to
//     the output;
//   * a persistent grid of a few blocks an SM, so the flushes are few.
// Every choice follows from shapes the wrapper sees (P, C, R).  A float64
// add to shared memory is a compare-and-swap loop on sm_90a (ATOMS.CAST
// .SPIN in the SASS), but at the demo's 29 rows an add it runs about once
// a chunk: carrying a chunk's last leaf in registers into the next chunks
// (each warp walking a contiguous slab) measured slower on the fit's
// stencil rows, 0.169 against 0.129 ms (NVIDIA H100 80GB HBM3, 700 W).
//
// Precision.  The terms are float32, as the plain twin builds them (the
// theta entry makes them in registers in the twin's order of operations:
// -u g, -u, (0.5 (-u)) |g|, and with procedural leaves -u sd and
// -u ((g.x q.x + g.y q.y) + g.z q.z)); every sum is float64 and the
// wrapper rounds once.  The FD stencil's +-1/2h cotangents cancel within
// a leaf's sum, so a float32 sum would keep an error of the terms' size.
// The order of the float64 additions changes from run to run, as
// index_add_'s does.  No FMA contraction (the nvcc-flags line), so the
// terms are the twin's bits.

// nvcc-flags: -fmad=false

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
// More resident blocks an SM only add flushes: 4 x 16 warps fill the SM.
constexpr int kMaxBlocksPerSm = 4;
constexpr int kMaxColumns = 16;

// A [R, C] row-major float32 table of terms: the colour rows, the
// analytic Hessian rows, any caller's columns.
template <int C>
struct Columns {
  static constexpr int kC = C;
  const float* vals;
  __device__ __forceinline__ void terms(int64_t r, double (&t)[C]) const {
    const float* row = vals + r * C;
#pragma unroll
    for (int c = 0; c < C; ++c) t[c] = static_cast<double>(__ldg(row + c));
  }
};

// scene_vjp.theta_cotangents' columns of a winner row, from its gradient
// g [R, 3] and SD cotangent u [R] (with procedural leaves also the SD
// sd [R] and the point q [R, 3]).  g and q are read through their strides
// (row, coordinate), so K2's structure-of-arrays gradients need no copy.
template <bool kProc>
struct Theta {
  static constexpr int kC = kProc ? 9 : 7;
  const float* g;
  int64_t g_row, g_col;
  const float* u;
  const float* sd;
  const float* q;
  int64_t q_row, q_col;
  __device__ __forceinline__ void terms(int64_t r, double (&t)[kC]) const {
    const float mu = -__ldg(u + r);
    const float* gr = g + r * g_row;
    const float gx = __ldg(gr), gy = __ldg(gr + g_col),
                gz = __ldg(gr + 2 * g_col);
    const float half = 0.5f * mu;
    t[0] = static_cast<double>(mu * gx);
    t[1] = static_cast<double>(mu * gy);
    t[2] = static_cast<double>(mu * gz);
    t[3] = static_cast<double>(mu);
    t[4] = static_cast<double>(half * fabsf(gx));
    t[5] = static_cast<double>(half * fabsf(gy));
    t[6] = static_cast<double>(half * fabsf(gz));
    if constexpr (kProc) {
      t[7] = static_cast<double>(mu * __ldg(sd + r));
      const float* qr = q + r * q_row;
      const float gq = (gx * __ldg(qr) + gy * __ldg(qr + q_col)) +
                       gz * __ldg(qr + 2 * q_col);
      t[8] = static_cast<double>(mu * gq);
    }
  }
};

// Block b sums rows [b * per_block, (b + 1) * per_block) of R; its warp w
// takes the 32-row chunks w, w + 16, ... of that range.  With `table` the
// block's sums live in shared memory (P * C doubles) until its end.
template <class Src>
__global__ void __launch_bounds__(kThreads)
    segment_sum_kernel(Src src, const int* __restrict__ idx, int64_t R,
                       int P, int64_t per_block, int table,
                       double* __restrict__ out) {
  constexpr int C = Src::kC;
  extern __shared__ double sums[];
  const int n = table ? P * C : 0;
  for (int e = threadIdx.x; e < n; e += kThreads) sums[e] = 0.0;
  __syncthreads();
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t hi = lo + per_block < R ? lo + per_block : R;
  for (int64_t base = lo + (threadIdx.x - lane); base < hi;
       base += kThreads) {
    const int64_t r = base + lane;
    int id = r < hi ? __ldg(idx + r) : -1;
    if (static_cast<unsigned>(id) >= static_cast<unsigned>(P)) id = -1;
    double t[C];
    if (id >= 0) {
      src.terms(r, t);
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) t[c] = 0.0;
    }
    // the runs of equal ids: after the five steps a run's head lane holds
    // the sum of its run (lane l adds lane l + off's partial while both
    // lie in l's run, which ends before lane `end`)
    const int prev = __shfl_up_sync(kFull, id, 1);
    const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != id);
    const unsigned later =
        lane == kWarp - 1 ? 0u : heads & (~0u << (lane + 1));
    const int end = later ? __ffs(later) - 1 : kWarp;
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const double o = __shfl_down_sync(kFull, t[c], off);
        if (lane + off < end) t[c] += o;
      }
    }
    // runs of one id that lie apart: the lowest head gathers the others'
    const bool live = id >= 0 && ((heads >> lane) & 1u);
    const unsigned lives = __ballot_sync(kFull, live);
    if (!live) continue;
    const unsigned peers = __match_any_sync(lives, id);
    const int leader = __ffs(peers) - 1;
    for (unsigned rest = peers & (peers - 1u); rest; rest &= rest - 1u) {
      const int from = __ffs(rest) - 1;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const double o = __shfl_sync(peers, t[c], from);
        if (lane == leader) t[c] += o;
      }
    }
    if (lane != leader) continue;
    if (table) {
#pragma unroll
      for (int c = 0; c < C; ++c) atomicAdd(sums + id * C + c, t[c]);
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c)
        atomicAdd(out + static_cast<int64_t>(id) * C + c, t[c]);
    }
  }
  if (!table) return;
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const double v = sums[e];
    if (v != 0.0) atomicAdd(out + e, v);
  }
}

template <class Src>
int launch(const Src& src, const int* idx, int64_t R, int P, double* out,
           cudaStream_t stream) {
  if (R == 0 || P == 0) return static_cast<int>(cudaGetLastError());
  auto kernel = segment_sum_kernel<Src>;
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t bytes = int64_t{8} * P * Src::kC;
  const int table = bytes <= optin;
  const unsigned smem = table ? static_cast<unsigned>(bytes) : 0u;
  if (smem > 48u * 1024u) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (per_sm > kMaxBlocksPerSm) per_sm = kMaxBlocksPerSm;
  const int64_t fit = static_cast<int64_t>(sms) * per_sm;
  const int64_t need = (R + kThreads - 1) / kThreads;
  const int64_t grid = need < fit ? need : fit;
  // whole 32-row chunks a block, so the chunks are the rows' own 32-row
  // blocks (what scene_vjp.merge_factor counts)
  const int64_t per_block =
      ((R + grid - 1) / grid + kWarp - 1) / kWarp * kWarp;
  const unsigned blocks =
      static_cast<unsigned>((R + per_block - 1) / per_block);
  kernel<<<blocks, kThreads, smem, stream>>>(src, idx, R, P, per_block,
                                             table, out);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int columns(int c, const float* vals, const int* idx, int64_t R, int P,
            double* out, cudaStream_t stream) {
  if (c == C) return launch(Columns<C>{vals}, idx, R, P, out, stream);
  if constexpr (C < kMaxColumns) {
    return columns<C + 1>(c, vals, idx, R, P, out, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// out [P, C] float64 (zeroed by the caller) += the rows of vals [R, C]
// float32 by idx [R] int32; 1 <= C <= 16.
extern "C" int rt_segment_sum(const void* idx, const void* vals, int C,
                              int64_t R, int P, void* out, void* stream) {
  if (C < 1 || C > kMaxColumns || R < 0 || P < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return columns<1>(C, static_cast<const float*>(vals),
                    static_cast<const int*>(idx), R, P,
                    static_cast<double*>(out),
                    static_cast<cudaStream_t>(stream));
}

// out [P, 7] float64 (zeroed by the caller) += theta_cotangents' columns
// of the winner rows idx [R] int32, g [R, 3] (strides g_row, g_col in
// floats), u [R]; with sd [R] and q [R, 3] (both or neither; strides
// q_row, q_col) the two procedural columns too, out [P, 9].
extern "C" int rt_segment_theta(const void* idx, const void* g,
                                int64_t g_row, int64_t g_col, const void* u,
                                const void* sd, const void* q, int64_t q_row,
                                int64_t q_col, int64_t R, int P, void* out,
                                void* stream) {
  if (R < 0 || P < 0 || (sd == nullptr) != (q == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* id = static_cast<const int*>(idx);
  auto* o = static_cast<double*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* gf = static_cast<const float*>(g);
  const auto* uf = static_cast<const float*>(u);
  if (sd == nullptr)
    return launch(Theta<false>{gf, g_row, g_col, uf, nullptr, nullptr, 0, 0},
                  id, R, P, o, st);
  return launch(Theta<true>{gf, g_row, g_col, uf,
                            static_cast<const float*>(sd),
                            static_cast<const float*>(q), q_row, q_col},
                id, R, P, o, st);
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
