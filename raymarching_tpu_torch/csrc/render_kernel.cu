// K1: the renderer's whole per-ray forward pipeline in one launch.
//
// Replaces raymarching_tpu/ops/pallas_render.py::_render_kernel (the
// pallas_call in _compiled_render_call; entry pallas_render_rays) for the
// reference shading model: primary march; first-wins colour winner at the
// pre-step point; 6-eval central-difference normal; one shadow march per
// light that stops at the light, with the black-lane and saturation-floor
// skips; Lambert sum clamped to [saturation, 1].  Its plain PyTorch twin is
// raymarching_tpu_torch/ops/render_kernel.py::render_rays_plain.
//
// Layout.  One thread per ray, 128 threads a block.  Ray inputs and outputs
// are structure-of-arrays rows of [R] float32, so loads and stores coalesce.
// The scene fold walks the int32 group and run descriptors of
// tables.pack_plan with warp-uniform control flow: every lane reads the same
// descriptor and the same primitive row at the same time, so the prim-type
// switch does not diverge and the row reads broadcast from the read-only
// cache.  The table stays in device memory (menger4's 8,424 rows are 270 KB,
// more than a block's shared memory), and one build serves every scene.
//
// What bounds it.  FP32 ALU issue and divergence, not bytes: a ray reads 24
// bytes and writes 32, against some 10 flops per leaf for every leaf of the
// scene at every march step.  A ray is frozen once done, so the lanes of a
// warp idle until its slowest ray finishes each march.  Making it fast is
// later work: warp-coherent pixel blocks (block ray order), the exact Menger
// lattice collapse, and code generated per plan.
//
// Exactness.  Built without fast math (IEEE sqrtf and division), and, by
// this kernel's own choice (the nvcc-flags line below; ops/build.py adds
// it to this kernel's build only), without FMA contraction, so every
// operation rounds once, as each PyTorch op of the plain twin does, and
// the kernel is bitwise equal to its twin.  A contracted build is about 9%
// faster at 1024x768 SSAA 3 on an H100 but moves a few chaotic hit points
// by up to ~1e-3, past the twin comparison's 1e-4 bound; dropping the flag
// needs that comparison restated as an agreement share.  The winner fold
// keeps strict < (the earliest leaf wins ties) and the cross SDF's median
// is the min/max network.  The saturation-floor bound and the shade loop
// take the Lambert term from one non-inlined function, so the bound holds
// for the loop's total bitwise whatever the compiler does with either call
// site.

// nvcc-flags: -fmad=false

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>
#include <limits>

namespace {

constexpr int kThreads = 128;
constexpr float kMaxStep = 1e5f;
constexpr float kInf = std::numeric_limits<float>::infinity();

// scene.csg.PrimType codes of the dense leaves
constexpr int kSphere = 0;
constexpr int kBox = 1;
constexpr int kCross = 2;

// What the scene fold reads: passed by value, so it lives in registers.
struct Scene {
  const float4* tbl;    // [P][2]: (cx, cy, cz, ax), (ay, az, 0, 0)
  const int4* groups;   // [G]: gsign, first run, number of runs, cullable
  const int4* runs;     // [N]: prim type, first leaf, leaf count, scale
  int n_groups;
  int root_min;         // 1 when the root folds with MIN, else 0 (MAX)
};

struct Params {
  Scene scene;
  const float4* lights;   // [L][2]: (x, y, z, 0), (r, g, b, 0)
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
  const float* org;       // [3][R] per-ray origins, or null
  float ox, oy, oz;       // the shared origin when org is null
  const float* dirs;      // [3][R]
  float* out;             // [6][R]: px, py, pz, sd, done, light
  int* iout;              // [2][R]: colour winner, shadow mask
  int64_t R;
};

__device__ __forceinline__ float med3(float a, float b, float c) {
  return fmaxf(fminf(a, b), fminf(fmaxf(a, b), c));
}

template <int kType>
__device__ __forceinline__ float leaf_sd(const float4* tbl, int i, float px,
                                         float py, float pz) {
  const float4 a = __ldg(tbl + 2 * i);
  if (kType == kSphere) {
    const float dx = px - a.x, dy = py - a.y, dz = pz - a.z;
    return sqrtf(dx * dx + dy * dy + dz * dz) - a.w;
  }
  const float4 b = __ldg(tbl + 2 * i + 1);
  const float bx = fabsf(px - a.x) - a.w * 0.5f;
  const float by = fabsf(py - a.y) - b.x * 0.5f;
  const float bz = fabsf(pz - a.z) - b.y * 0.5f;
  if (kType == kBox) return fmaxf(fmaxf(bx, by), bz);
  return med3(bx, by, bz);
}

// min over one run of scale * leaf sd, from acc.
template <int kType>
__device__ __forceinline__ float fold_span(const float4* tbl, int4 run,
                                           float px, float py, float pz,
                                           float acc) {
  const float scale = static_cast<float>(run.w);
  for (int i = run.y; i < run.y + run.z; ++i)
    acc = fminf(acc, scale * leaf_sd<kType>(tbl, i, px, py, pz));
  return acc;
}

__device__ __forceinline__ float fold_run(const float4* tbl, int4 run,
                                          float px, float py, float pz,
                                          float acc) {
  switch (run.x) {
    case kSphere: return fold_span<kSphere>(tbl, run, px, py, pz, acc);
    case kBox: return fold_span<kBox>(tbl, run, px, py, pz, acc);
    default: return fold_span<kCross>(tbl, run, px, py, pz, acc);
  }
}

struct Winner {
  float sd;
  int idx;
};

// (min, first argmin) over one run: strict < keeps the earliest leaf
// (body.cpp:12-14 first-wins ties).
template <int kType>
__device__ __forceinline__ Winner fold_span_idx(const float4* tbl, int4 run,
                                                float px, float py, float pz,
                                                Winner acc) {
  const float scale = static_cast<float>(run.w);
  for (int i = run.y; i < run.y + run.z; ++i) {
    const float sd = scale * leaf_sd<kType>(tbl, i, px, py, pz);
    if (sd < acc.sd) acc = Winner{sd, i};
  }
  return acc;
}

__device__ __forceinline__ Winner fold_run_idx(const float4* tbl, int4 run,
                                               float px, float py, float pz,
                                               Winner acc) {
  switch (run.x) {
    case kSphere: return fold_span_idx<kSphere>(tbl, run, px, py, pz, acc);
    case kBox: return fold_span_idx<kBox>(tbl, run, px, py, pz, acc);
    default: return fold_span_idx<kCross>(tbl, run, px, py, pz, acc);
  }
}

// Scene SDF: the two-level fold of pallas_march._scene_sd_tile over the
// plain leaf runs.  A cullable (DIFFERENCE) group first folds its base runs
// (scale -1, always leading); its value max(base, -carve...) is at least
// -gmin of the base, so when that bound already reaches the running scene
// minimum the carve cannot change the result and is skipped (per lane:
// exact).
__device__ __noinline__ float scene_sd(Scene s, float px, float py,
                                       float pz) {
  const float rsign = s.root_min ? 1.0f : -1.0f;
  float running = kInf;
  for (int gi = 0; gi < s.n_groups; ++gi) {
    const int4 g = __ldg(s.groups + gi);
    const int end = g.y + g.z;
    int k = g.y;
    float gmin = kInf;
    if (g.w) {
      for (; k < end; ++k) {
        const int4 run = __ldg(s.runs + k);
        if (run.w != -1) break;
        gmin = fold_run(s.tbl, run, px, py, pz, gmin);
      }
      if (-gmin >= running) continue;
    }
    for (; k < end; ++k)
      gmin = fold_run(s.tbl, __ldg(s.runs + k), px, py, pz, gmin);
    running = fminf(running, rsign * (static_cast<float>(g.x) * gmin));
  }
  return rsign * running;
}

// Scene SDF and colour winner leaf (-1: none), pallas_march
// ._scene_sd_idx_tile: strict < at every level, the same exact cull (a
// culled group's value is >= the running minimum, so it cannot win).
__device__ __noinline__ Winner scene_sd_idx(Scene s, float px, float py,
                                            float pz) {
  const float rsign = s.root_min ? 1.0f : -1.0f;
  Winner root{kInf, -1};
  for (int gi = 0; gi < s.n_groups; ++gi) {
    const int4 g = __ldg(s.groups + gi);
    const int end = g.y + g.z;
    int k = g.y;
    Winner w{kInf, -1};
    if (g.w) {
      for (; k < end; ++k) {
        const int4 run = __ldg(s.runs + k);
        if (run.w != -1) break;
        w = fold_run_idx(s.tbl, run, px, py, pz, w);
      }
      if (-w.sd >= root.sd) continue;
    }
    for (; k < end; ++k)
      w = fold_run_idx(s.tbl, __ldg(s.runs + k), px, py, pz, w);
    const float v = rsign * (static_cast<float>(g.x) * w.sd);
    if (v < root.sd) root = Winner{v, w.idx};
  }
  return Winner{rsign * root.sd, root.idx};
}

struct Hit {
  float x, y, z, sd;
  bool done;
};

// Masked march (core.march / pallas_render._march_values): up to
// `iterations` evaluations, position update before the convergence check,
// steps clamped to kMaxStep.  With has_tmax (shadow rays) the ray is also
// done once (p - o) . d reaches tmax.  A ray that starts done takes no step.
__device__ __forceinline__ Hit march(Scene s, int iterations, float eps,
                                     float ox, float oy, float oz, float dx,
                                     float dy, float dz, bool has_tmax,
                                     float tmax, bool done) {
  float px = ox, py = oy, pz = oz, sd_last = kInf;
  for (int it = 0; it < iterations && !done; ++it) {
    const float sd = scene_sd(s, px, py, pz);
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
  return Hit{px, py, pz, sd_last, done};
}

// Unit direction from p to light li (xyz) and the Lambert term n . dir (w).
// Not inlined: the saturation-floor bound and the shade loop must round it
// identically for the skip to stay exact.
__device__ __noinline__ float4 light_dir(const float4* lights, int li,
                                         float px, float py, float pz,
                                         float nx, float ny, float nz) {
  const float4 l = __ldg(lights + 2 * li);
  float rx = l.x - px, ry = l.y - py, rz = l.z - pz;
  const float rd = sqrtf(rx * rx + ry * ry + rz * rz);
  const float rinv = 1.0f / fmaxf(rd, FLT_MIN);
  rx = rx * rinv;
  ry = ry * rinv;
  rz = rz * rinv;
  return make_float4(rx, ry, rz, nx * rx + ny * ry + nz * rz);
}

__global__ void __launch_bounds__(kThreads) render_kernel(const Params P) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= P.R) return;
  const int64_t R = P.R;
  const Scene s = P.scene;
  float ox = P.ox, oy = P.oy, oz = P.oz;
  if (P.org != nullptr) {
    ox = P.org[i];
    oy = P.org[R + i];
    oz = P.org[2 * R + i];
  }
  const float dx = P.dirs[i], dy = P.dirs[R + i], dz = P.dirs[2 * R + i];

  // 1. primary march
  const Hit hit = march(s, P.iterations, P.eps, ox, oy, oz, dx, dy, dz,
                        false, 0.0f, false);
  const float px = hit.x, py = hit.y, pz = hit.z;

  // 2. colour winner at the pre-step point (scene.cpp:34-42)
  const float back = fminf(hit.sd, kMaxStep);
  const int cidx =
      scene_sd_idx(s, px - back * dx, py - back * dy, pz - back * dz).idx;

  // black-lane skip: a miss or a black winner shades to black whatever the
  // light, so its shadow marches start done
  bool skip = false;
  if (P.shadows && P.n_black >= 0) {
    bool isb = cidx < 0;
    for (int k = 0; k < P.n_black; ++k) isb = isb || cidx == __ldg(P.black + k);
    skip = isb;
  }

  // 3. normal: unscaled central differences, normalised with a tiny floor
  const float h = P.fd_h;
  const float gx = scene_sd(s, px + h, py, pz) - scene_sd(s, px - h, py, pz);
  const float gy = scene_sd(s, px, py + h, pz) - scene_sd(s, px, py - h, pz);
  const float gz = scene_sd(s, px, py, pz + h) - scene_sd(s, px, py, pz - h);
  const float gn = sqrtf(gx * gx + gy * gy + gz * gz);
  const float inv = 1.0f / fmaxf(gn, FLT_MIN);
  const float nx = gx * inv, ny = gy * inv, nz = gz * inv;

  // saturation-floor skip: if even the all-lit sum of max(n . l, 0) stays
  // below the clamp floor, every shadow outcome shades to `saturation`
  if (P.shadows && P.sat_skip && P.n_lights > 0) {
    float upper = 0.0f;
    for (int li = 0; li < P.n_lights; ++li)
      upper = upper +
              fmaxf(light_dir(P.lights, li, px, py, pz, nx, ny, nz).w, 0.0f);
    skip = skip || upper < P.saturation;
  }

  // 4. Lambert over lights with hard shadows (scene.cpp:45-62); a skipped
  // lane's march stays at its origin and so reads as shadowed
  float total = 0.0f;
  unsigned smask = 0u;
  for (int li = 0; li < P.n_lights; ++li) {
    const float4 r = light_dir(P.lights, li, px, py, pz, nx, ny, nz);
    float lamb = r.w;
    if (P.shadows) {
      const float4 l = __ldg(P.lights + 2 * li);
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

  P.out[i] = px;
  P.out[R + i] = py;
  P.out[2 * R + i] = pz;
  P.out[3 * R + i] = hit.sd;
  P.out[4 * R + i] = hit.done ? 1.0f : 0.0f;
  P.out[5 * R + i] = fminf(fmaxf(total, P.saturation), 1.0f);
  P.iout[i] = cidx;
  P.iout[R + i] = static_cast<int>(smask);
}

}  // namespace

// Launch K1 on `stream` over R rays; returns cudaGetLastError().
extern "C" int rt_render_rays(const void* tbl, const void* lights,
                              const void* groups, const void* runs,
                              const void* black, int n_groups, int root_min,
                              int n_lights, int n_black, int shadows,
                              int sat_skip, int iterations, float eps,
                              float off, float saturation, float fd_h,
                              const void* org, float ox, float oy, float oz,
                              const void* dirs, void* out, void* iout,
                              int64_t R, void* stream) {
  Params P;
  P.scene = Scene{static_cast<const float4*>(tbl),
                  static_cast<const int4*>(groups),
                  static_cast<const int4*>(runs), n_groups, root_min};
  P.lights = static_cast<const float4*>(lights);
  P.black = static_cast<const int*>(black);
  P.n_lights = n_lights;
  P.n_black = n_black;
  P.shadows = shadows;
  P.sat_skip = sat_skip;
  P.iterations = iterations;
  P.eps = eps;
  P.off = off;
  P.saturation = saturation;
  P.fd_h = fd_h;
  P.org = static_cast<const float*>(org);
  P.ox = ox;
  P.oy = oy;
  P.oz = oz;
  P.dirs = static_cast<const float*>(dirs);
  P.out = static_cast<float*>(out);
  P.iout = static_cast<int*>(iout);
  P.R = R;
  if (R > 0) {
    const unsigned blocks = static_cast<unsigned>((R + kThreads - 1) / kThreads);
    render_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(P);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
