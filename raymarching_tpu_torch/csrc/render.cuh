// K1's per-ray loop, shared by its three sources: the reference entries
// (render_kernel.cu), the extended-shading entries (render_ext_kernel.cu)
// and the in-kernel raygen entries (render_raygen_kernel.cu).  One thread
// renders one ray: the primary march (march.cuh), then shade.cuh's
// shading; a warp takes the next 32 consecutive rays from the counter
// (persist.cuh) until none is left.
//
// Two compile-time arguments pick what an entry does beyond the reference
// pipeline, so the reference entries keep their code:
//   kExt     the shading extensions (shade.cuh's kExt): the light term
//            and the factors go to RenderExt's buffers;
//   kRaygen  the directions come from the ray index instead of a [3][R]
//            buffer: pallas_render._raygen_dirs in scan order, the camera
//            model of core.camera.generate_rays evaluated per thread.

#pragma once

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
  float rk, rW, rH;
  const float* cam;
  int64_t base;         // the chunk's first ray of the frame
};

// Direction of ray i of the chunk (pallas_render._raygen_dirs, scan order:
// the same products with reciprocals, z = -1 so the norm's z^2 is 1).
__device__ __forceinline__ float3 raygen_dir(const Raygen& G, unsigned i) {
  const float* c = G.cam;
  const int64_t r = G.base + i;
  const int64_t S = static_cast<int64_t>(G.k) * G.k;
  const int64_t s = r % S, t1 = r / S;
  const float px = static_cast<float>(t1 % G.W);
  const float py = static_cast<float>(t1 / G.W);
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

// The rays of one thread, the body of every K1 entry.  E is RenderExt with
// kExt (else NoExt), G Raygen with kRaygen (else NoExt).
template <int kNormal, bool kExt, bool kRaygen, class S, class E = NoExt,
          class G = NoExt>
__device__ __forceinline__ void render_loop(const Params& P,
                                            const E& ext = E{},
                                            const G& gen = G{}) {
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
