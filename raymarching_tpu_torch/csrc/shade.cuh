// Steps 2-4 of the per-ray pipeline, shared by K1 (render_kernel.cu) and K4
// (shade_kernel.cu): pallas_render._shade_body for the reference shading
// model.  Given a marched hit point: the first-wins colour winner at the
// pre-step point; the normal; one shadow march per light that stops at
// the light, with the black-lane and saturation-floor skips; the Lambert
// sum clamped to [saturation, 1].
//
// The normal is a compile-time choice, a template argument of shade() and
// of both kernels' loops, with one entry function a normal in each, so
// each instantiation keeps only its own registers:
// kNormalFd, the 6-eval central difference (reference parity); or
// kNormalAnalytic, the gradient of the scene_sd_idx<PathWinner> winner at
// the hit (fold.cuh's winner_grad; JAX _scene_sd_idx_grad_tile, the
// save-the-winner form of the analytic normal), one fold instead of six,
// which also writes that winner's (sd, leaf, gradient) as the fused
// backward's residuals when the kernel is given somewhere to put them.
// JAX's gradient-only fold (_scene_sd_grad_tile) carries three gradient
// floats through every select; this one carries the winner and evaluates
// its gradient once, which keeps the value fold's register budget.  The
// analytic normal is one non-inlined function and the analytic entries
// ask for kAnalyticBlocks resident blocks an SM: the FD entries' 48
// registers in the shared view.
//
// Layout.  One thread shades one hit, one point a walk of the scene: the
// winner fold (leaf by leaf), then the normal's six value folds or its
// one winner fold, then the lights' shadow marches one after the other.
//
// What bounds it.  The shadow marches: on the demo at 512x512 SSAA 2 they
// are 94% of K4's device time (NVIDIA H100 80GB HBM3, 700.00 W;
// chip_smoke.py's [phases]), and a march is bound by the latency of the
// fold's dependent chain (descriptor, row, excess, min), not by the
// instruction rate: a launch waits on its slowest lane, whose two marches
// are one serial chain ([tail]).  Two designs that put several points
// into one walk of the scene (fold.cuh's scene_sd_n, which K2 uses) were
// built here and measured slower on that card in the same run, bitwise
// equal outputs, and were taken out: the normal's six points in one walk
// (K4 1.655 against 1.634 ms, K1 2.246 against 2.062 ms), and the two
// lights' shadow rays marching in lockstep, two points a walk (K4 1.819
// against 1.634 ms, K1 3.335 against 2.062 ms).  A walk of two points has
// two minimum chains where the one-point collapse already runs four, so a
// lockstep step costs about two steps; it ends after max(steps) walks
// where the serial marches take their sum, which the slowest lane's one
// long march does not shorten; and the N-point functions raised both
// kernels from 72 to 80 registers and from 10 to 6-7 resident blocks an
// SM.  A third, the shadow march as a function of its own that is not
// inlined (so the shading's live state is saved around the call, not
// around every evaluation inside it), moved K4 from 1.68 to 1.62 ms and K1
// at 512x512 SSAA 2 from 2.23 to 2.10 ms but K1 at 1024x768 SSAA 3 from
// 10.0 to 11.2 ms, and was taken out too.

#pragma once

#include <cfloat>

#include "march.cuh"

namespace {

struct ShadeParams {
  const int* black;       // [n_black] leaf ids of compile-time black prims
  int n_lights;
  int n_black;            // < 0: black-lane skip off
  int shadows;
  int sat_skip;
  int iterations;
  float eps;
  float off;              // surface_eps + offset_eps: the shadow-ray lift
  float saturation;
  float fd_h;
};

struct Shade {
  int cidx;      // colour winner leaf, -1 = none
  float light;   // clamped Lambert term
  int smask;     // bit l set = light l shadowed
};

// shade()'s normal estimators
constexpr int kNormalFd = 0;
constexpr int kNormalAnalytic = 1;

// Resident blocks an SM that K1's and K4's analytic entries are built for
// (the second argument of their __launch_bounds__; 48 registers).  The FD
// entries keep the register count ptxas picks under
// __launch_bounds__(kThreads) alone (72 / 48, device / shared view):
// asking them for even one resident block an SM changes that choice
// (105-109 registers; the demo at 1024x768 SSAA 3, K1 10.0 -> 13.8 ms).
// The analytic entries left alone take 72 / 72 registers (K1) and 72 / 80
// (K4).  Demo, NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py --times, in
// turns: K1 at 1024x768 SSAA 3 10.26 and 9.80 ms with 10 blocks, 10.81
// with 8, 10.66 and 10.70 left alone; at 512x512 SSAA 2 2.12 and 2.18,
// 2.08, 2.04; K4 on the 512x512 SSAA 2 hits 1.39-1.42 ms with 8 or 10,
// 1.41 left alone (FD: K1 10.0 and 2.2 ms, K4 1.67).
constexpr int kAnalyticBlocks = 10;

// Where the analytic normal's winner residuals of ray i of R go: (sd, gx,
// gy, gz) to f[k R + i], the winner leaf to idx[i]; nowhere when f is null.
struct WinnerOut {
  float* f;
  int* idx;
  unsigned i, R;
};

// Unit direction from p to light li (xyz) and the Lambert term n . dir (w).
// Not inlined: the saturation-floor bound and the shade loop must round it
// identically for the skip to stay exact.
template <class S>
__device__ __noinline__ float4 light_dir(const S s, int li, float px, float py,
                                         float pz, float nx, float ny,
                                         float nz) {
  const float4 l = s.light(2 * li);
  float rx = l.x - px, ry = l.y - py, rz = l.z - pz;
  const float rd = sqrtf(rx * rx + ry * ry + rz * rz);
  const float rinv = 1.0f / fmaxf(rd, FLT_MIN);
  rx = rx * rinv;
  ry = ry * rinv;
  rz = rz * rinv;
  return make_float4(rx, ry, rz, nx * rx + ny * ry + nz * rz);
}

// The analytic normal at (px, py, pz), not normalised: the gradient of the
// scene_sd_idx<PathWinner> winner; its (sd, leaf, gradient) go to `wo`.
// Not inlined: a call leaves the entry the registers of a call, as the FD
// normal's six scene_sd calls do (inlined, K1 at 1024x768 SSAA 3 took
// 11.0-11.6 ms against the FD entry's 10.0; see kAnalyticBlocks).
template <class S>
__device__ __noinline__ float3 analytic_normal(const S s, float px, float py,
                                               float pz, const WinnerOut wo) {
  const PathWinner w = scene_sd_idx<PathWinner>(s, px, py, pz);
  const float3 g = winner_grad(s, w, px, py, pz);
  if (wo.f != nullptr) {
    wo.f[wo.i] = w.sd;
    wo.f[wo.R + wo.i] = g.x;
    wo.f[2 * wo.R + wo.i] = g.y;
    wo.f[3 * wo.R + wo.i] = g.z;
    wo.idx[wo.i] = w.idx;
  }
  return g;
}

// Shade the hit point (px, py, pz) of a ray of direction (dx, dy, dz) whose
// march last evaluated the SD `sd` one step back; with kNormalAnalytic,
// write the normal's winner residuals to `wo`.
template <int kNormal, class S>
__device__ __forceinline__ Shade shade(const S& s, const ShadeParams P,
                                       float px, float py, float pz,
                                       float sd, float dx, float dy,
                                       float dz, const WinnerOut wo) {
  // 2. colour winner at the pre-step point (scene.cpp:34-42)
  const float back = fminf(sd, kMaxStep);
  const int cidx =
      scene_sd_idx<Winner>(s, px - back * dx, py - back * dy, pz - back * dz)
          .idx;

  // black-lane skip: a miss or a black winner shades to black whatever the
  // light, so its shadow marches start done
  bool skip = false;
  if (P.shadows && P.n_black >= 0) {
    bool isb = cidx < 0;
    for (int k = 0; k < P.n_black; ++k) isb = isb || cidx == __ldg(P.black + k);
    skip = isb;
  }

  // 3. normal: unscaled central differences, or the winner's gradient at
  // the hit; normalised with a tiny floor
  float gx, gy, gz;
  if constexpr (kNormal == kNormalAnalytic) {
    const float3 g = analytic_normal(s, px, py, pz, wo);
    gx = g.x;
    gy = g.y;
    gz = g.z;
  } else {
    const float h = P.fd_h;
    gx = scene_sd(s, px + h, py, pz) - scene_sd(s, px - h, py, pz);
    gy = scene_sd(s, px, py + h, pz) - scene_sd(s, px, py - h, pz);
    gz = scene_sd(s, px, py, pz + h) - scene_sd(s, px, py, pz - h);
  }
  const float gn = sqrtf(gx * gx + gy * gy + gz * gz);
  const float inv = 1.0f / fmaxf(gn, FLT_MIN);
  const float nx = gx * inv, ny = gy * inv, nz = gz * inv;

  // saturation-floor skip: if even the all-lit sum of max(n . l, 0) stays
  // below the clamp floor, every shadow outcome shades to `saturation`
  if (P.shadows && P.sat_skip && P.n_lights > 0) {
    float upper = 0.0f;
    for (int li = 0; li < P.n_lights; ++li)
      upper = upper +
              fmaxf(light_dir(s, li, px, py, pz, nx, ny, nz).w, 0.0f);
    skip = skip || upper < P.saturation;
  }

  // 4. Lambert over lights with hard shadows (scene.cpp:45-62); a skipped
  // lane's march stays at its origin and so reads as shadowed
  float total = 0.0f;
  unsigned smask = 0u;
  for (int li = 0; li < P.n_lights; ++li) {
    const float4 r = light_dir(s, li, px, py, pz, nx, ny, nz);
    float lamb = r.w;
    if (P.shadows) {
      const float4 l = s.light(2 * li);
      const float sx = px + nx * P.off, sy = py + ny * P.off,
                  sz = pz + nz * P.off;
      const float tx = l.x - sx, ty = l.y - sy, tz = l.z - sz;
      const float tmax = sqrtf(tx * tx + ty * ty + tz * tz);
      const Hit q = march(s, P.iterations, P.eps, sx, sy, sz, r.x, r.y, r.z,
                          true, tmax, skip);
      const bool passed =
          (l.x - q.x) * r.x + (l.y - q.y) * r.y + (l.z - q.z) * r.z <= 0.0f;
      if (!passed) {
        smask |= 1u << li;
        lamb = 0.0f;
      }
    }
    total = total + lamb;
  }
  return Shade{cidx, fminf(fmaxf(total, P.saturation), 1.0f),
               static_cast<int>(smask)};
}

}  // namespace
