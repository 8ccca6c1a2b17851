// K1's per-ray loop, shared by its four sources: the reference entries
// (render_kernel.cu), the extended-shading entries (render_ext_kernel.cu),
// the in-kernel raygen entries (render_raygen_kernel.cu) and the
// mirror-bounce entries (render_bounce_kernel.cu).  One thread
// renders one ray: the primary march (march.cuh), then shade.cuh's
// shading; a warp takes the next 32 consecutive rays from the counter
// (persist.cuh) until none is left.
//
// Three compile-time arguments pick what an entry does beyond the reference
// pipeline, so the reference entries keep their code:
//   kExt     the shading extensions (shade.cuh's kExt): the light term
//            and the factors go to RenderExt's buffers;
//   kRaygen  the directions come from the ray index instead of a [3][R]
//            buffer: pallas_render._raygen_dirs in scan order, the camera
//            model of core.camera.generate_rays evaluated per thread;
//   kBounce  mirror bounces after the primary hit (bounce_ray), with the
//            extended shading.

#pragma once

#include <cstddef>
#include <cstdint>

#include "persist.cuh"
#include "shade.cuh"

namespace {

struct Params {
  SceneArgs scene;
  ShadeParams shade;      // also the primary march's iterations and eps
  const float* org;       // [3][R] per-ray origins, or null
  float ox, oy, oz;       // the shared origin when org is null
  const float* dirs;      // [3][R] (unused by the raygen entries)
  float* out;             // [6][R]: px, py, pz, sd, done, light (the
                          // extended entries write rows 0-4 only)
  int* iout;              // [2][R]: colour winner, shadow mask
  float* wres;            // analytic: [4][R] winner sd, gx, gy, gz, or null
  int* widx;              // analytic: [R] winner leaf (with wres)
  unsigned* counter;      // [1]: the next ray to hand out, zero at launch
  unsigned R;
};

// The extended entries' switches and buffers: light [3][R] (coloured) or
// [R], sfac [L][R] and aofac [R] (null when their extension is off).
struct RenderExt {
  ShadeExt x;
  float* light;
  float* sfac;
  float* aofac;
};

// RenderExt of the entries for more than kMaxAoSamples AO taps.
struct FarRenderExt {
  FarShadeExt x;
  float* light;
  float* sfac;
  float* aofac;
};

// The raygen entries' camera: ray `base + i` of the frame is SSAA sample
// s = r % k^2 of pixel r / k^2 in scan order, at sub-pixel ((s / k + 1) /
// k, (s % k + 1) / k); 1/k, 1/W and 1/H are doubles rounded once to
// float32, as the JAX kernel's constants are.  `cam` is the device copy of
// core.camera.serve_cam_rows' [3][8] rows (position, focal width and
// height; the rotation row-major from row 1), read in the kernel as the
// JAX kernel reads its camera from SMEM, so the host neither computes
// nor waits for them.
struct Raygen {
  int W, H, k;
  int bh, bw;           // block order's pixel block, or 0, 0: scan order
  float rk, rW, rH;
  const float* cam;
  int64_t base;         // the chunk's first ray of the frame
};

// Whether (bh, bw) is scan order (0, 0) or a pixel block that tiles a W x
// H frame.
inline bool valid_block(int W, int H, int bh, int bw) {
  if (bh == 0 && bw == 0) return true;
  return bh > 0 && bw > 0 && H % bh == 0 && W % bw == 0;
}

// Direction of ray i of the chunk (pallas_render._raygen_dirs: the same
// products with reciprocals, z = -1 so the norm's z^2 is 1).  The ray
// index names a pixel and sample in scan order, or with bh, bw in block
// order (core.order.to_blocked: bh x bw pixel blocks, block-row major,
// the JAX kernel's `bh, bw` arm).
__device__ __forceinline__ float3 raygen_dir(const Raygen& G, unsigned i) {
  const float* c = G.cam;
  const int64_t r = G.base + i;
  const int64_t S = static_cast<int64_t>(G.k) * G.k;
  const int64_t s = r % S, t1 = r / S;
  int64_t pxi = t1 % G.W, pyi = t1 / G.W;
  if (G.bh) {
    const int64_t gw = G.W / G.bw, t2 = t1 / G.bw, t3 = t2 / G.bh;
    pxi = (t3 % gw) * G.bw + t1 % G.bw;
    pyi = (t3 / gw) * G.bh + t2 % G.bh;
  }
  const float px = static_cast<float>(pxi);
  const float py = static_cast<float>(pyi);
  const float si = static_cast<float>(s / G.k);
  const float sj = static_cast<float>(s % G.k);
  const float u = (px + (si + 1.0f) * G.rk) * G.rW;
  const float v = (py + (sj + 1.0f) * G.rk) * G.rH;
  const float x = __ldg(c + 3) * (u - 0.5f);
  const float y = __ldg(c + 4) * (0.5f - v);
  const float n = sqrtf(x * x + y * y + 1.0f);
  const float xc = x / n, yc = y / n, zc = -1.0f / n;
  const float* rot = c + 8;
  return make_float3(
      xc * __ldg(rot) + yc * __ldg(rot + 1) + zc * __ldg(rot + 2),
      xc * __ldg(rot + 3) + yc * __ldg(rot + 4) + zc * __ldg(rot + 5),
      xc * __ldg(rot + 6) + yc * __ldg(rot + 7) + zc * __ldg(rot + 8));
}

// Ray i with mirror bounces (pallas_render._render_kernel :284-309): the
// primary march and shade, then `bounces` times: reflect the direction off
// the unit normal the shade returned (d and n are unit, so the mirrored
// direction needs no renormalisation), lift the origin off the hit by
// P.shade.off (surface_eps + offset_eps rounded once, the shadow rays'
// lift), march and shade again.  Shade set b (0 the primary hit) goes to
// rows b of every output, B = bounces: P.out [1 + B][5][R] (px, py, pz,
// sd, done), P.iout [1 + B][2][R] (colour winner, shadow mask), ext.light
// [1 + B][C][R] (C = 3 with coloured lights, else 1), ext.sfac
// [1 + B][L][R] and ext.aofac [1 + B][R] when their extension is on.
// No winner residuals: the backward replays the bounce chain (JAX's
// save_winner is reflection-free), and the host turns the black-lane skip
// off (JAX passes black_ids = () with bounces).  One march and one shade
// in the code, whatever the count: nothing is kept per bounce.
template <int kNormal, class S, class E>
__device__ __forceinline__ void bounce_ray(const S& s, const Params& P,
                                           const E& ext, int bounces,
                                           unsigned i, float ox, float oy,
                                           float oz, float dx, float dy,
                                           float dz) {
  const unsigned R = P.R;
  const size_t C = ext.x.colored ? 3 : 1;
  const size_t L = static_cast<size_t>(P.shade.n_lights);
  const auto row = [&](size_t k) { return k * R + i; };
  for (int b = 0;; ++b) {
    const Hit hit = march(s, P.shade.iterations, P.shade.eps, ox, oy, oz, dx,
                          dy, dz, false, 0.0f, false);
    const Shade sh = shade<kNormal, true>(
        s, P.shade, hit.x, hit.y, hit.z, hit.sd, dx, dy, dz,
        WinnerOut{nullptr, nullptr, i, R}, ext.x,
        ShadeExtOut{ext.light + C * b * R,
                    ext.sfac != nullptr ? ext.sfac + L * b * R : nullptr,
                    ext.aofac != nullptr ? ext.aofac + size_t{1} * b * R
                                         : nullptr,
                    i, R});
    const size_t g = 5 * static_cast<size_t>(b);
    P.out[row(g)] = hit.x;
    P.out[row(g + 1)] = hit.y;
    P.out[row(g + 2)] = hit.z;
    P.out[row(g + 3)] = hit.sd;
    P.out[row(g + 4)] = hit.done ? 1.0f : 0.0f;
    P.iout[row(2 * static_cast<size_t>(b))] = sh.cidx;
    P.iout[row(2 * static_cast<size_t>(b) + 1)] = sh.smask;
    if (b == bounces) break;
    // d - (2 (d . n)) n and p + n off, in the JAX kernel's order
    const float t = 2.0f * (dx * sh.nx + dy * sh.ny + dz * sh.nz);
    dx = dx - t * sh.nx;
    dy = dy - t * sh.ny;
    dz = dz - t * sh.nz;
    ox = hit.x + sh.nx * P.shade.off;
    oy = hit.y + sh.ny * P.shade.off;
    oz = hit.z + sh.nz * P.shade.off;
  }
}

// The rays of one thread, the body of every K1 entry.  E is RenderExt with
// kExt (else NoExt), G Raygen with kRaygen (else NoExt); with kBounce
// (and kExt) each ray takes `bounces` mirror bounces (bounce_ray).
template <int kNormal, bool kExt, bool kRaygen, class S, class E = NoExt,
          class G = NoExt, bool kBounce = false>
__device__ __forceinline__ void render_loop(const Params& P,
                                            const E& ext = E{},
                                            const G& gen = G{},
                                            int bounces = 0) {
  const S s = stage_scene<S>(P.scene);
  const unsigned R = P.R;
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
    float dx, dy, dz;
    if constexpr (kRaygen) {
      ox = __ldg(gen.cam);
      oy = __ldg(gen.cam + 1);
      oz = __ldg(gen.cam + 2);
      const float3 d = raygen_dir(gen, i);
      dx = d.x;
      dy = d.y;
      dz = d.z;
    } else {
      dx = P.dirs[i];
      dy = P.dirs[R + i];
      dz = P.dirs[2 * R + i];
    }
    if constexpr (kBounce) {
      static_assert(kExt, "the bounce entries take the extended shading");
      bounce_ray<kNormal>(s, P, ext, bounces, i, ox, oy, oz, dx, dy, dz);
      continue;
    }

    // 1. primary march
    const Hit hit = march(s, P.shade.iterations, P.shade.eps, ox, oy, oz, dx,
                          dy, dz, false, 0.0f, false);

    // 2-4. colour winner, normal, shadows, Lambert clamp (and with kExt
    // the extensions, whose outputs shade() writes itself)
    Shade sh;
    if constexpr (kExt) {
      sh = shade<kNormal, true>(
          s, P.shade, hit.x, hit.y, hit.z, hit.sd, dx, dy, dz,
          WinnerOut{P.wres, P.widx, i, R}, ext.x,
          ShadeExtOut{ext.light, ext.sfac, ext.aofac, i, R});
    } else {
      sh = shade<kNormal>(s, P.shade, hit.x, hit.y, hit.z, hit.sd, dx, dy,
                          dz, WinnerOut{P.wres, P.widx, i, R});
    }

    P.out[i] = hit.x;
    P.out[R + i] = hit.y;
    P.out[2 * R + i] = hit.z;
    P.out[3 * R + i] = hit.sd;
    P.out[4 * R + i] = hit.done ? 1.0f : 0.0f;
    if constexpr (!kExt) P.out[5 * R + i] = sh.light;
    P.iout[i] = sh.cidx;
    P.iout[R + i] = sh.smask;
  }
}

// Params of a launch from the C entry points' arguments.
inline Params make_params(const SceneArgs& scene, const ShadeParams& shade,
                          const void* org, float ox, float oy, float oz,
                          const void* dirs, void* out, void* iout, void* wres,
                          void* widx, void* counter, int64_t R) {
  Params P;
  P.scene = scene;
  P.shade = shade;
  P.org = static_cast<const float*>(org);
  P.ox = ox;
  P.oy = oy;
  P.oz = oz;
  P.dirs = static_cast<const float*>(dirs);
  P.out = static_cast<float*>(out);
  P.iout = static_cast<int*>(iout);
  P.wres = static_cast<float*>(wres);
  P.widx = static_cast<int*>(widx);
  P.counter = static_cast<unsigned*>(counter);
  P.R = static_cast<unsigned>(R);
  return P;
}

// Whether a launch's ray count and residual request are valid: R in [0,
// kMaxRays], and residuals only with the analytic normal.
inline bool valid_launch(int64_t R, int analytic, const void* wres) {
  return R >= 0 && R <= kMaxRays && !(analytic == 0 && wres != nullptr);
}

}  // namespace
