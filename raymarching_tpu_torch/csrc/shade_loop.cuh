// K4's per-ray loop, shared by its reference entries (shade_kernel.cu) and
// its extended-shading entries (shade_ext_kernel.cu): one thread shades
// one hit that comes in (shade.cuh's shade), a warp takes the next 32
// consecutive rays from the counter (persist.cuh) until none is left.

#pragma once

#include <cstdint>

#include "persist.cuh"
#include "shade.cuh"

namespace {

// The rays' buffers: in [7][R] (p xyz, sd, direction xyz), light [R] (the
// extended entries: [3][R] with coloured lights), iout [2][R] (colour
// winner, shadow mask), and with the analytic normal the winner residuals
// wres [4][R] (sd, gx, gy, gz) and widx [R], or null.
struct Rays {
  const float* in;
  float* light;
  int* iout;
  float* wres;
  int* widx;
  unsigned* counter;   // [1]: the next ray to hand out, zero at launch
  unsigned R;
};

// The extended entries' switches and factor buffers: sfac [L][R] and
// aofac [R] (null when their extension is off).
struct ShadeRaysExt {
  ShadeExt x;
  float* sfac;
  float* aofac;
};

// ShadeRaysExt of the entries for more than kMaxAoSamples AO taps.
struct FarShadeRaysExt {
  FarShadeExt x;
  float* sfac;
  float* aofac;
};

// The rays of one thread, the body of every K4 entry; E is ShadeRaysExt
// with kExt, else NoExt.
template <int kNormal, bool kExt, class S, class E = NoExt>
__device__ __forceinline__ void shade_loop(const SceneArgs& A,
                                           const ShadeParams& P,
                                           const Rays& B,
                                           const E& ext = E{}) {
  const S s = stage_scene<S>(A);
  const unsigned R = B.R;
  const float* in = B.in;
  for (;;) {
    const unsigned base = next_rays(B.counter);
    if (base >= R) break;
    const unsigned i = base + (threadIdx.x & 31u);
    if (i >= R) continue;
    if constexpr (kExt) {
      const Shade sh = shade<kNormal, true>(
          s, P, in[i], in[R + i], in[2 * R + i], in[3 * R + i],
          in[4 * R + i], in[5 * R + i], in[6 * R + i],
          WinnerOut{B.wres, B.widx, i, R}, ext.x,
          ShadeExtOut{B.light, ext.sfac, ext.aofac, i, R});
      B.iout[i] = sh.cidx;
      B.iout[R + i] = sh.smask;
    } else {
      const Shade sh = shade<kNormal>(
          s, P, in[i], in[R + i], in[2 * R + i], in[3 * R + i],
          in[4 * R + i], in[5 * R + i], in[6 * R + i],
          WinnerOut{B.wres, B.widx, i, R});
      B.light[i] = sh.light;
      B.iout[i] = sh.cidx;
      B.iout[R + i] = sh.smask;
    }
  }
}

// Rays from a C entry point's arguments.
inline Rays make_rays(const void* in, void* light, void* iout, void* wres,
                      void* widx, void* counter, int64_t R) {
  return Rays{static_cast<const float*>(in), static_cast<float*>(light),
              static_cast<int*>(iout),       static_cast<float*>(wres),
              static_cast<int*>(widx),       static_cast<unsigned*>(counter),
              static_cast<unsigned>(R)};
}

}  // namespace
