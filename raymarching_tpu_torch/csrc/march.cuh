// The sphere-tracing march shared by K1 (render_kernel.cu), K3
// (march_kernel.cu) and, through shade.cuh, K4 (shade_kernel.cu).
//
// One definition, so the hit points K3 hands to K4 in the two-phase path
// are the very points K1 marches to in one launch, bitwise, when the
// kernels are built without FMA contraction.

#pragma once

#include "fold.cuh"

namespace {

constexpr float kMaxStep = 1e5f;

struct Hit {
  float x, y, z, sd;
  bool done;
  int steps;   // scene evaluations this ray took (unused by K1 and K4)
};

// Masked march (core.march / pallas_march._march_kernel): up to
// `iterations` evaluations, position update before the convergence check,
// steps clamped to kMaxStep.  With has_tmax (shadow rays) the ray is also
// done once (p - o) . d reaches tmax.  A ray that starts done takes no
// step and keeps sd = +inf.
//
// kPen (the extended shading's shadow rays, a compile-time argument so the
// other marches keep their code): with soft_k > 0 (a warp-uniform switch)
// also track the penumbra factor *pen = min over the steps of
// clamp(soft_k sd / max(t, eps), 0, 1), t = (p - o) . d at the point
// before the step (pallas_render._march_values' soft_k); *pen starts at 1
// and a ray that takes no step keeps it.
template <bool kPen = false, class S>
__device__ __forceinline__ Hit march(const S& s, int iterations, float eps,
                                     float ox, float oy, float oz, float dx,
                                     float dy, float dz, bool has_tmax,
                                     float tmax, bool done,
                                     float soft_k = 0.0f,
                                     float* pen = nullptr) {
  float px = ox, py = oy, pz = oz, sd_last = kInf;
  int it = 0;
  for (; it < iterations && !done; ++it) {
    const float sd = scene_sd(s, px, py, pz);
    if constexpr (kPen) {
      if (soft_k > 0.0f) {
        const float t = (px - ox) * dx + (py - oy) * dy + (pz - oz) * dz;
        const float ratio =
            fminf(fmaxf(soft_k * sd / fmaxf(t, eps), 0.0f), 1.0f);
        *pen = fminf(*pen, ratio);
      }
    }
    const float step = fminf(sd, kMaxStep);
    px = px + step * dx;
    py = py + step * dy;
    pz = pz + step * dz;
    sd_last = sd;
    done = sd < eps;
    if (has_tmax) {
      const float t = (px - ox) * dx + (py - oy) * dy + (pz - oz) * dz;
      done = done || t >= tmax;
    }
  }
  return Hit{px, py, pz, sd_last, done, it};
}

}  // namespace
