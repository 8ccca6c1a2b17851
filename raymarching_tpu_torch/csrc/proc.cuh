// The procedural fractal leaves of the scene fold (fold.cuh), for all four
// kernels: pallas_march's D7.
//
// Replaces raymarching_tpu/ops/pallas_march.py::_mandelbox_sd (:71) and
// _mandelbox_sd_grad (:93), _mandelbulb_sd (:160) and _mandelbulb_sd_grad
// (:288, on the _Jet dual numbers of :208-287), _julia_sd (:343) and
// _julia_sd_grad (:386), dispatched by the run type as _prim_sd (:433)
// and _prim_sd_grad (:2004) dispatch their tuple-tagged runs.  The plain
// twins are raymarching_tpu_torch/core/proc.py's functions, written in
// the same order of operations: with -fmad=false every operation here
// rounds once, as each PyTorch op there does.
//
// Layout.  A run of type kMandelbox, kMandelbulb or kJulia holds leaves
// of one (kind, parameter, iterations): tables.pack_plan never lets
// leaves with other parameters share a run.  A leaf's row is (cx, cy, cz,
// size), (ay, az, iterations, its procedural row), and its procedural row
// (tables.scene_operands appends one a procedural leaf) holds the
// Mandelbox's fold scale, the Mandelbulb's power (fixed at 8, unused) or
// the Julia constant.  The iteration count is a runtime loop bound: every
// lane of a warp folds the same leaf, so the loop is warp-uniform.
//
// Cost.  One evaluation is `iterations` times a dense leaf's work or more
// (core/proc.py's PROC_VALUE_OPS and PROC_GRAD_OPS count it), so these are
// __noinline__: a scene view without procedural leaves (fold.cuh's
// kProc false) compiles none of it, and the procedural views keep their
// folds' registers for the dense leaves.  The gradients are forward-mode
// sweeps: the Mandelbox's 3x3 Jacobian written out by hand, the others the
// value iteration on Jet.  Floors sit inside the argument of the op they
// guard (the JAX package's discipline), the Mandelbox's final square root
// included (the 1e-24 floor of JAX's oracle, value-neutral above it).

#pragma once

#include <cuda_runtime.h>

namespace {

// scene.csg.PrimType codes of the procedural leaves (tables.PROC_TYPES)
constexpr int kMandelbox = 3;
constexpr int kMandelbulb = 4;
constexpr int kJulia = 5;

// One procedural leaf as its rows give it.
struct ProcLeaf {
  float cx, cy, cz, size;
  int iters;
  float4 param;
};

// Leaf i's rows.  A staged scene has halved the fourth column of every row
// of a run that is not a sphere's (persist.cuh, exact): the size is twice
// what it holds.
template <class S>
__device__ __forceinline__ ProcLeaf proc_leaf(const S& s, int i) {
  const float4 a = s.row(2 * i);
  const float4 b = s.row(2 * i + 1);
  return ProcLeaf{a.x, a.y, a.z, S::kStaged ? 2.0f * a.w : a.w,
                  static_cast<int>(b.z), s.row(2 * static_cast<int>(b.w))};
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// The Mandelbox DE: box fold, sphere fold f = r2 < 1 ? 1 / max(r2, 1/4)
// : 1, q = scale f q + q0, dr = |scale| f dr + 1; size |q| / dr.
__device__ __forceinline__ float mandelbox_value(const ProcLeaf& L, float px,
                                                 float py, float pz) {
  const float ms = L.param.x, ams = fabsf(ms);
  const float q0x = (px - L.cx) / L.size, q0y = (py - L.cy) / L.size,
              q0z = (pz - L.cz) / L.size;
  float qx = q0x, qy = q0y, qz = q0z, dr = 1.0f;
#pragma unroll 1
  for (int it = 0; it < L.iters; ++it) {
    qx = clampf(qx, -1.0f, 1.0f) * 2.0f - qx;
    qy = clampf(qy, -1.0f, 1.0f) * 2.0f - qy;
    qz = clampf(qz, -1.0f, 1.0f) * 2.0f - qz;
    const float r2 = qx * qx + qy * qy + qz * qz;
    const float f = r2 < 1.0f ? 1.0f / fmaxf(r2, 0.25f) : 1.0f;
    const float sf = ms * f;
    qx = sf * qx + q0x;
    qy = sf * qy + q0y;
    qz = sf * qz + q0z;
    dr = ams * f * dr + 1.0f;
  }
  return L.size * sqrtf(fmaxf(qx * qx + qy * qy + qz * qz, 1e-24f)) / dr;
}

// The power-8 Mandelbulb DE: the trig-free triplex step w <- w^8 + q0,
// masked escape at m > 256, w clipped to +-16 and m to 65536 in the step,
// the (x, z) radius floored at 1e-10.
__device__ __forceinline__ float mandelbulb_value(const ProcLeaf& L, float px,
                                                  float py, float pz) {
  const float q0x = (px - L.cx) / L.size, q0y = (py - L.cy) / L.size,
              q0z = (pz - L.cz) / L.size;
  float wx = q0x, wy = q0y, wz = q0z;
  float m = wx * wx + wy * wy + wz * wz, dz = 1.0f;
#pragma unroll 1
  for (int it = 0; it < L.iters; ++it) {
    const bool esc = m > 256.0f;
    const float x = clampf(wx, -16.0f, 16.0f), y = clampf(wy, -16.0f, 16.0f),
                z = clampf(wz, -16.0f, 16.0f);
    const float mq = fminf(m, 65536.0f);
    const float dz_new =
        8.0f * (mq * mq * mq) * sqrtf(fmaxf(mq, 1e-12f)) * dz + 1.0f;
    const float x2 = x * x, y2 = y * y, z2 = z * z;
    const float x4 = x2 * x2, y4 = y2 * y2, z4 = z2 * z2;
    const float s2 = x2 + z2;
    const float s = sqrtf(fmaxf(s2, 1e-20f));
    const float inv = 1.0f / fmaxf(s, 1e-10f);
    const float ux = x * inv, uz = z * inv;
    const float ux2 = ux * ux, uz2 = uz * uz;
    const float ux4 = ux2 * ux2, uz4 = uz2 * uz2;
    const float k1 = x4 + y4 + z4 - 6.0f * y2 * z2 - 6.0f * x2 * y2 +
                     2.0f * z2 * x2;
    const float k4 = x2 - y2 + z2;
    const float pa =
        ux * uz * (ux2 - uz2) * (ux4 - 6.0f * ux2 * uz2 + uz4);
    const float pb = ux4 * ux4 - 28.0f * ux4 * ux2 * uz2 +
                     70.0f * ux4 * uz4 - 28.0f * ux2 * uz2 * uz4 + uz4 * uz4;
    const float yk = y * k4 * k1 * s;
    const float nx = 64.0f * yk * pa + q0x;
    const float ny = -16.0f * y2 * s2 * k4 * k4 + k1 * k1 + q0y;
    const float nz = -8.0f * yk * pb + q0z;
    const float m_new = nx * nx + ny * ny + nz * nz;
    if (!esc) {
      wx = nx;
      wy = ny;
      wz = nz;
      dz = dz_new;
      m = m_new;
    }
  }
  m = fmaxf(m, 1e-12f);
  return L.size * 0.25f * logf(m) * sqrtf(m) / dz;
}

// The quaternion z^2 + c Julia DE on the slice w = 0: masked escape at
// m > 16, the quaternion clipped to +-8 and m to 4096 in the step.
__device__ __forceinline__ float julia_value(const ProcLeaf& L, float px,
                                             float py, float pz) {
  const float4 c = L.param;
  float a = (px - L.cx) / L.size, b = (py - L.cy) / L.size,
        cq = (pz - L.cz) / L.size, d = 0.0f;
  float m = a * a + b * b + cq * cq + d * d, md = 1.0f;
#pragma unroll 1
  for (int it = 0; it < L.iters; ++it) {
    const bool esc = m > 16.0f;
    const float mq = fminf(m, 4096.0f);
    const float md_new = 2.0f * sqrtf(fmaxf(mq, 1e-12f)) * md;
    const float ax = clampf(a, -8.0f, 8.0f), bx = clampf(b, -8.0f, 8.0f),
                cx = clampf(cq, -8.0f, 8.0f), dx = clampf(d, -8.0f, 8.0f);
    const float na = ax * ax - bx * bx - cx * cx - dx * dx + c.x;
    const float nb = 2.0f * ax * bx + c.y;
    const float nc = 2.0f * ax * cx + c.z;
    const float nd = 2.0f * ax * dx + c.w;
    const float m_new = na * na + nb * nb + nc * nc + nd * nd;
    if (!esc) {
      a = na;
      b = nb;
      cq = nc;
      d = nd;
      md = md_new;
      m = m_new;
    }
  }
  m = fmaxf(m, 1e-12f);
  md = fmaxf(md, 1e-12f);
  return L.size * 0.25f * sqrtf(m) * logf(m) / md;
}

// The DE of procedural leaf L of run type `type` at (px, py, pz).
__device__ __noinline__ float proc_value(int type, const ProcLeaf L, float px,
                                         float py, float pz) {
  switch (type) {
    case kMandelbox: return mandelbox_value(L, px, py, pz);
    case kMandelbulb: return mandelbulb_value(L, px, py, pz);
    case kJulia: return julia_value(L, px, py, pz);
    default: __builtin_unreachable();
  }
}

// d DE / dp of a Mandelbox leaf: the Jacobian J = dq/dp (box fold flips
// its rows, the sphere fold is a rank-one update through df/dr2 = -f^2)
// and d dr / dp ride along the iteration.
__device__ __forceinline__ float3 mandelbox_gradient(const ProcLeaf& L,
                                                     float px, float py,
                                                     float pz) {
  const float ms = L.param.x, asf = fabsf(ms);
  const float s0 = 1.0f / L.size;
  const float q0x = (px - L.cx) / L.size, q0y = (py - L.cy) / L.size,
              q0z = (pz - L.cz) / L.size;
  float qx = q0x, qy = q0y, qz = q0z, dr = 1.0f;
  float jxx = s0 + 0.0f, jyy = jxx, jzz = jxx;
  float jxy = 0.0f, jxz = 0.0f, jyx = 0.0f, jyz = 0.0f, jzx = 0.0f,
        jzy = 0.0f;
  float dx_ = 0.0f, dy_ = 0.0f, dz_ = 0.0f;
#pragma unroll 1
  for (int it = 0; it < L.iters; ++it) {
    const float bx = fabsf(qx) <= 1.0f ? 1.0f : -1.0f;
    const float by = fabsf(qy) <= 1.0f ? 1.0f : -1.0f;
    const float bz = fabsf(qz) <= 1.0f ? 1.0f : -1.0f;
    qx = clampf(qx, -1.0f, 1.0f) * 2.0f - qx;
    qy = clampf(qy, -1.0f, 1.0f) * 2.0f - qy;
    qz = clampf(qz, -1.0f, 1.0f) * 2.0f - qz;
    jxx = bx * jxx; jxy = bx * jxy; jxz = bx * jxz;
    jyx = by * jyx; jyy = by * jyy; jyz = by * jyz;
    jzx = bz * jzx; jzy = bz * jzy; jzz = bz * jzz;
    const float r2 = qx * qx + qy * qy + qz * qz;
    const float f = r2 < 1.0f ? 1.0f / fmaxf(r2, 0.25f) : 1.0f;
    const float fp = (r2 > 0.25f && r2 < 1.0f) ? -f * f : 0.0f;
    const float r2x = 2.0f * (qx * jxx + qy * jyx + qz * jzx);
    const float r2y = 2.0f * (qx * jxy + qy * jyy + qz * jzy);
    const float r2z = 2.0f * (qx * jxz + qy * jyz + qz * jzz);
    const float fx = fp * r2x, fy = fp * r2y, fz = fp * r2z;
    const float sf = ms * f;
    jxx = sf * jxx + ms * qx * fx + s0;
    jxy = sf * jxy + ms * qx * fy;
    jxz = sf * jxz + ms * qx * fz;
    jyx = sf * jyx + ms * qy * fx;
    jyy = sf * jyy + ms * qy * fy + s0;
    jyz = sf * jyz + ms * qy * fz;
    jzx = sf * jzx + ms * qz * fx;
    jzy = sf * jzy + ms * qz * fy;
    jzz = sf * jzz + ms * qz * fz + s0;
    qx = sf * qx + q0x;
    qy = sf * qy + q0y;
    qz = sf * qz + q0z;
    dx_ = asf * (f * dx_ + dr * fx);
    dy_ = asf * (f * dy_ + dr * fy);
    dz_ = asf * (f * dz_ + dr * fz);
    dr = asf * f * dr + 1.0f;
  }
  const float r = sqrtf(qx * qx + qy * qy + qz * qz);
  const float rinv = 1.0f / fmaxf(r, 1e-30f);
  const float rx = (qx * jxx + qy * jyx + qz * jzx) * rinv;
  const float ry = (qx * jxy + qy * jyy + qz * jzy) * rinv;
  const float rz = (qx * jxz + qy * jyz + qz * jzz) * rinv;
  const float inv_dr2 = 1.0f / (dr * dr);
  return make_float3(L.size * (rx * dr - r * dx_) * inv_dr2,
                     L.size * (ry * dr - r * dy_) * inv_dr2,
                     L.size * (rz * dr - r * dz_) * inv_dr2);
}

// A value and its three tangents d/dp (pallas_march._Jet; core/proc.py's
// Jet): a product's tangent is a.t b.v + a.v b.t, a difference the sum
// with the negation (the same bits as a - b).
struct Jet {
  float v, x, y, z;
};

__device__ __forceinline__ Jet operator+(Jet a, Jet b) {
  return Jet{a.v + b.v, a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ Jet operator+(Jet a, float c) {
  return Jet{a.v + c, a.x, a.y, a.z};
}
__device__ __forceinline__ Jet operator-(Jet a, Jet b) {
  return Jet{a.v + -b.v, a.x + -b.x, a.y + -b.y, a.z + -b.z};
}
__device__ __forceinline__ Jet operator*(Jet a, Jet b) {
  return Jet{a.v * b.v, a.x * b.v + a.v * b.x, a.y * b.v + a.v * b.y,
             a.z * b.v + a.v * b.z};
}
__device__ __forceinline__ Jet operator*(Jet a, float c) {
  return Jet{a.v * c, a.x * c, a.y * c, a.z * c};
}
__device__ __forceinline__ Jet operator*(float c, Jet a) { return a * c; }

// A unary op's jet: value v, the tangents times its derivative g.
__device__ __forceinline__ Jet jet_unary(float v, float g, Jet a) {
  return Jet{v, g * a.x, g * a.y, g * a.z};
}
__device__ __forceinline__ Jet jet_sqrt_floor(Jet a, float floor) {
  const float r = sqrtf(fmaxf(a.v, floor));
  return jet_unary(r, a.v > floor ? 0.5f / r : 0.0f, a);
}
__device__ __forceinline__ Jet jet_log_floor(Jet a, float floor) {
  const float v = fmaxf(a.v, floor);
  return jet_unary(logf(v), a.v > floor ? 1.0f / v : 0.0f, a);
}
__device__ __forceinline__ Jet jet_min_c(Jet a, float c) {
  return jet_unary(fminf(a.v, c), a.v < c ? 1.0f : 0.0f, a);
}
__device__ __forceinline__ Jet jet_max_c(Jet a, float c) {
  return jet_unary(fmaxf(a.v, c), a.v > c ? 1.0f : 0.0f, a);
}
__device__ __forceinline__ Jet jet_clip(Jet a, float lo, float hi) {
  return jet_unary(clampf(a.v, lo, hi), (a.v > lo && a.v < hi) ? 1.0f : 0.0f,
                   a);
}
__device__ __forceinline__ Jet jet_inv_floor(Jet a, float floor) {
  const float v = fmaxf(a.v, floor);
  const float inv = 1.0f / v;
  return jet_unary(inv, a.v > floor ? -inv * inv : 0.0f, a);
}

// The seed jets (p - c) * (1 / size), tangents diag(1 / size).
__device__ __forceinline__ void jet_seed(const ProcLeaf& L, float px,
                                         float py, float pz, Jet& qx, Jet& qy,
                                         Jet& qz) {
  const float inv_s = 1.0f / L.size;
  const float s0 = inv_s + 0.0f;
  qx = Jet{(px - L.cx) * inv_s, s0, 0.0f, 0.0f};
  qy = Jet{(py - L.cy) * inv_s, 0.0f, s0, 0.0f};
  qz = Jet{(pz - L.cz) * inv_s, 0.0f, 0.0f, s0};
}

// d DE / dp of a Mandelbulb leaf: mandelbulb_value's iteration on jets.
__device__ __forceinline__ float3 mandelbulb_gradient(const ProcLeaf& L,
                                                      float px, float py,
                                                      float pz) {
  Jet q0x, q0y, q0z;
  jet_seed(L, px, py, pz, q0x, q0y, q0z);
  Jet wx = q0x, wy = q0y, wz = q0z;
  Jet m = wx * wx + wy * wy + wz * wz;
  Jet dz{1.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 1
  for (int it = 0; it < L.iters; ++it) {
    const bool esc = m.v > 256.0f;
    const Jet x = jet_clip(wx, -16.0f, 16.0f), y = jet_clip(wy, -16.0f, 16.0f),
              z = jet_clip(wz, -16.0f, 16.0f);
    const Jet mq = jet_min_c(m, 65536.0f);
    const Jet dz_new =
        8.0f * (mq * mq * mq) * jet_sqrt_floor(mq, 1e-12f) * dz + 1.0f;
    const Jet x2 = x * x, y2 = y * y, z2 = z * z;
    const Jet x4 = x2 * x2, y4 = y2 * y2, z4 = z2 * z2;
    const Jet s2 = x2 + z2;
    const Jet s = jet_sqrt_floor(s2, 1e-20f);
    const Jet inv = jet_inv_floor(s, 1e-10f);
    const Jet ux = x * inv, uz = z * inv;
    const Jet ux2 = ux * ux, uz2 = uz * uz;
    const Jet ux4 = ux2 * ux2, uz4 = uz2 * uz2;
    const Jet k1 = x4 + y4 + z4 - 6.0f * (y2 * z2) - 6.0f * (x2 * y2) +
                   2.0f * (z2 * x2);
    const Jet k4 = x2 - y2 + z2;
    const Jet pa = ux * uz * (ux2 - uz2) * (ux4 - 6.0f * (ux2 * uz2) + uz4);
    const Jet pb = ux4 * ux4 - 28.0f * (ux4 * (ux2 * uz2)) +
                   70.0f * (ux4 * uz4) - 28.0f * ((ux2 * uz2) * uz4) +
                   uz4 * uz4;
    const Jet yk = y * k4 * k1 * s;
    const Jet nx = 64.0f * yk * pa + q0x;
    const Jet ny = -16.0f * (y2 * s2) * (k4 * k4) + k1 * k1 + q0y;
    const Jet nz = -8.0f * yk * pb + q0z;
    const Jet m_new = nx * nx + ny * ny + nz * nz;
    if (!esc) {
      wx = nx;
      wy = ny;
      wz = nz;
      dz = dz_new;
      m = m_new;
    }
  }
  const Jet lg = jet_log_floor(m, 1e-12f);
  const Jet rt = jet_sqrt_floor(m, 1e-12f);
  const Jet inv_dz = jet_inv_floor(dz, 0.0f);
  const Jet de = 0.25f * lg * rt * inv_dz;
  return make_float3(L.size * de.x, L.size * de.y, L.size * de.z);
}

// d DE / dp of a Julia leaf: julia_value's iteration on jets.
__device__ __forceinline__ float3 julia_gradient(const ProcLeaf& L, float px,
                                                 float py, float pz) {
  const float4 c = L.param;
  Jet a, b, cq;
  jet_seed(L, px, py, pz, a, b, cq);
  Jet d{0.0f, 0.0f, 0.0f, 0.0f};
  Jet m = a * a + b * b + cq * cq + d * d;
  Jet md{1.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 1
  for (int it = 0; it < L.iters; ++it) {
    const bool esc = m.v > 16.0f;
    const Jet mq = jet_min_c(m, 4096.0f);
    const Jet md_new = 2.0f * jet_sqrt_floor(mq, 1e-12f) * md;
    const Jet ax = jet_clip(a, -8.0f, 8.0f), bx = jet_clip(b, -8.0f, 8.0f),
              cx = jet_clip(cq, -8.0f, 8.0f), dx = jet_clip(d, -8.0f, 8.0f);
    const Jet na = ax * ax - bx * bx - cx * cx - dx * dx + c.x;
    const Jet nb = 2.0f * (ax * bx) + c.y;
    const Jet nc = 2.0f * (ax * cx) + c.z;
    const Jet nd = 2.0f * (ax * dx) + c.w;
    const Jet m_new = na * na + nb * nb + nc * nc + nd * nd;
    if (!esc) {
      a = na;
      b = nb;
      cq = nc;
      d = nd;
      md = md_new;
      m = m_new;
    }
  }
  const Jet rt = jet_sqrt_floor(m, 1e-12f);
  const Jet lg = jet_log_floor(m, 1e-12f);
  const Jet inv_md = jet_inv_floor(jet_max_c(md, 1e-12f), 0.0f);
  const Jet de = 0.25f * rt * lg * inv_md;
  return make_float3(L.size * de.x, L.size * de.y, L.size * de.z);
}

// d DE / dp of procedural leaf L of run type `type` at (px, py, pz).
__device__ __noinline__ float3 proc_gradient(int type, const ProcLeaf L,
                                             float px, float py, float pz) {
  switch (type) {
    case kMandelbox: return mandelbox_gradient(L, px, py, pz);
    case kMandelbulb: return mandelbulb_gradient(L, px, py, pz);
    case kJulia: return julia_gradient(L, px, py, pz);
    default: __builtin_unreachable();
  }
}

}  // namespace
