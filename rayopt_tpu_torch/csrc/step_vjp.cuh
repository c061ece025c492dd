// The hand-derived reverse of one surface step (trace_common.cuh
// surface_step), shared by the merit-gradient kernels of grad.cu (K7,
// K9, row flags read at run time) and the kernels specialized per spec
// tuple in grad_spec.cuh (K5, row flags as compile-time constants).
// Its torch model, line for line, is cuda_grad._step_vjp_reference.

#pragma once

#include "trace_common.cuh"

namespace {

constexpr int SLOTS = 6;      // parameter cotangents a row: cuda_grad.SLOTS

// Hand-derived reverse of surface_step for one live ray, the flags and
// the row pointer as in surface_step.  s: the state
// entering the row (global frame).  g: in, the cotangent of the state
// leaving the row; out, the cotangent of s.
// pg: out, the row's parameter cotangents (c, k, offset x, y, z, mu;
// with PATH also n_before).  With PATH, ct_path is the cotangent of the
// row's optical path t * n_before (K9); without it the path has none
// and the code is K5's.  The aperture clip is a constant mask: a
// clipped ray is dead.
template <typename T, bool PATH = false, typename Flags = int,
          typename Row = const T*>
__device__ __forceinline__ void surface_step_vjp(Row p, Flags flags,
                                                 const T* s, T* g, T* pg,
                                                 T ct_path = T(0)) {
  const int fl = flag_value(flags);
  const bool off_axis = fl & F_OFF_AXIS;
  const bool rotated = fl & F_ROTATED;
  const bool flat = fl & F_FLAT;
  const bool sph = fl & F_SPHERICAL;
  const int kind = (fl >> KIND_SHIFT) & 3;
  const T c = p[P_C];
  const T k = p[P_K];
  const T mu = p[P_MU];
  T x = s[0], y = s[1], z = s[2], ux = s[3], uy = s[4], uz = s[5];
  // ---- forward recompute ----
  if (off_axis) {
    x = x - p[P_OFF];
    y = y - p[P_OFF + 1];
  }
  z = z - p[P_OFF + 2];
  if (rotated) {
    rot_apply(p + P_ROT, x, y, z);
    rot_apply(p + P_ROT, ux, uy, uz);
  }
  const T sg = (fl & F_ALTERNATE) ? T(-1) : T(1);
  T t, uzs = T(1), k1 = T(1), uyd = T(0), uu = T(1), yy = T(0);
  T d = T(0), e = T(0), f = T(0), sq = T(0), q = T(0), den = T(1);
  bool conj = false;
  if (flat) {
    uzs = uz == T(0) ? T(1) : uz;
    t = -z / uzs;
  } else {
    if (sph) {
      uyd = ux * x + uy * y + uz * z;
      yy = x * x + y * y + z * z;
    } else {
      k1 = T(1) + k;
      uyd = ux * x + uy * y + k1 * uz * z;
      uu = ux * ux + uy * uy + k1 * uz * uz;
      yy = x * x + y * y + k1 * z * z;
    }
    d = c * uyd - uz;
    e = c * uu;
    f = c * yy - T(2) * z;
    sq = sqrt0(d * d - e * f);
    q = sg * sq;
    // intercept_spec's pair: f / (q - d) (conj) or -(d + q) / e
    conj = d * q <= T(0) || e == T(0);
    den = conj ? q - d : e;
    if (den == T(0)) den = T(1);
    t = (conj ? f : -(d + q)) / den;
  }
  const T x1 = x + t * ux;
  const T y1 = y + t * uy;
  const T z1 = z + t * uz;
  // ---- reverse: leave the row's frame ----
  T gx1 = g[0], gy1 = g[1], gz1 = g[2], gvx = g[3], gvy = g[4], gvz = g[5];
  if (rotated) {
    rot_apply(p + P_ROT, gx1, gy1, gz1);
    rot_apply(p + P_ROT, gvx, gvy, gvz);
  }
  T gc = T(0), gk = T(0), gmu = T(0), gux, guy, guz;
  // ---- reverse: refraction ----
  if (kind == 0) {
    gux = gvx; guy = gvy; guz = gvz;
  } else if (flat && kind == 2) {
    gux = gvx; guy = gvy; guz = -gvz;
  } else if (flat) {
    const T muf = fabs(mu);
    const T sgmu = sgn(mu);
    const T a = muf * uz;
    const T sq2 = sqrt0(a * a - (mu * mu - T(1)));
    T gmuf = ux * gvx + uy * gvy + uz * gvz;
    gux = muf * gvx; guy = muf * gvy; guz = muf * gvz;
    const T gq2 = gvz;
    const T gdisc2 = gq2 * sgmu * T(0.5) / sq2;
    const T ga = -gq2 + T(2) * a * gdisc2;
    gmu = -T(2) * mu * gdisc2;
    gmuf = gmuf + uz * ga;
    guz = guz + muf * ga;
    gmu = gmu + sgmu * gmuf;
  } else {
    const T kc = sph ? c : (T(1) + k) * c;
    const T nx = -c * x1;
    const T ny = -c * y1;
    const T nz = T(1) - kc * z1;
    const T dot = ux * nx + uy * ny + uz * nz;
    const T ir2 = sph ? T(1) : T(1) / (nx * nx + ny * ny + nz * nz);
    T gir2 = T(0), gdot, gnx, gny, gnz;
    if (kind == 2) {
      const T a2 = sph ? T(2) * dot : T(2) * dot * ir2;
      gux = gvx; guy = gvy; guz = gvz;
      gnx = -a2 * gvx; gny = -a2 * gvy; gnz = -a2 * gvz;
      const T ga2 = -(gvx * nx + gvy * ny + gvz * nz);
      if (sph) {
        gdot = T(2) * ga2;
      } else {
        gdot = T(2) * ir2 * ga2;
        gir2 = T(2) * dot * ga2;
      }
    } else {
      const T muf = fabs(mu);
      const T sgmu = sgn(mu);
      T a, disc2;
      if (sph) {
        a = muf * dot;
        disc2 = a * a - (mu * mu - T(1));
      } else {
        a = muf * dot * ir2;
        disc2 = a * a - (mu * mu - T(1)) * ir2;
      }
      const T sq2 = sqrt0(disc2);
      const T q2 = -a + sgmu * sq2;
      T gmuf = ux * gvx + uy * gvy + uz * gvz;
      gux = muf * gvx; guy = muf * gvy; guz = muf * gvz;
      const T gq2 = gvx * nx + gvy * ny + gvz * nz;
      gnx = q2 * gvx; gny = q2 * gvy; gnz = q2 * gvz;
      const T gdisc2 = gq2 * sgmu * T(0.5) / sq2;
      const T ga = -gq2 + T(2) * a * gdisc2;
      if (sph) {
        gmu = -T(2) * mu * gdisc2;
        gmuf = gmuf + dot * ga;
        gdot = muf * ga;
      } else {
        gmu = -T(2) * mu * ir2 * gdisc2;
        gir2 = -(mu * mu - T(1)) * gdisc2 + muf * dot * ga;
        gmuf = gmuf + dot * ir2 * ga;
        gdot = muf * ir2 * ga;
      }
      gmu = gmu + sgmu * gmuf;
    }
    gux = gux + gdot * nx; guy = guy + gdot * ny; guz = guz + gdot * nz;
    gnx = gnx + gdot * ux; gny = gny + gdot * uy; gnz = gnz + gdot * uz;
    if (!sph) {
      const T s2 = -T(2) * ir2 * ir2 * gir2;
      gnx = gnx + s2 * nx; gny = gny + s2 * ny; gnz = gnz + s2 * nz;
      gk = gk - c * z1 * gnz;
    }
    const T zc = sph ? z1 : (T(1) + k) * z1;
    gc = gc - x1 * gnx - y1 * gny - zc * gnz;
    gx1 = gx1 - c * gnx; gy1 = gy1 - c * gny; gz1 = gz1 - kc * gnz;
  }
  // ---- reverse: transfer x1 = x + t u ----
  T gx = gx1, gy = gy1, gz = gz1;
  gux = gux + t * gx1; guy = guy + t * gy1; guz = guz + t * gz1;
  T gt = ux * gx1 + uy * gy1 + uz * gz1;
  if constexpr (PATH) {
    gt = gt + ct_path * p[P_NB];
    pg[6] = ct_path * t;
  }
  // ---- reverse: intercept ----
  if (flat) {
    gz = gz - gt / uzs;
    if (uz != T(0)) guz = guz + gt * z / (uzs * uzs);
  } else {
    // the derivative of the form the ray took (den is e when not conj)
    T gd, gq, ge = T(0), gf = T(0);
    if (conj) {
      const T dd = q != d ? gt * f / (den * den) : T(0);
      gf = gt / den;
      gd = dd;
      gq = -dd;
    } else {
      gd = gq = -gt / den;
      ge = gt * (d + q) / (den * den);
    }
    const T gdisc = gq * sg * T(0.5) / sq;
    gd = gd + T(2) * d * gdisc;
    ge = ge - f * gdisc;
    gf = gf - e * gdisc;
    gc = gc + yy * gf + uu * ge + uyd * gd;
    const T gyy = c * gf;
    const T guyd = c * gd;
    gz = gz - T(2) * gf;
    guz = guz - gd;
    gx = gx + T(2) * x * gyy + ux * guyd;
    gy = gy + T(2) * y * gyy + uy * guyd;
    gz = gz + T(2) * k1 * z * gyy + k1 * uz * guyd;
    gux = gux + x * guyd;
    guy = guy + y * guyd;
    guz = guz + k1 * z * guyd;
    if (!sph) {
      const T guu = c * ge;
      gux = gux + T(2) * ux * guu;
      guy = guy + T(2) * uy * guu;
      guz = guz + T(2) * k1 * uz * guu;
      gk = gk + z * z * gyy + uz * uz * guu + uz * z * guyd;
    }
  }
  // ---- reverse: enter the row's frame ----
  if (rotated) {
    rot_apply_t(p + P_ROT, gx, gy, gz);
    rot_apply_t(p + P_ROT, gux, guy, guz);
  }
  g[0] = gx; g[1] = gy; g[2] = gz;
  g[3] = gux; g[4] = guy; g[5] = guz;
  pg[0] = gc;
  pg[1] = gk;
  pg[2] = off_axis ? -gx : T(0);
  pg[3] = off_axis ? -gy : T(0);
  pg[4] = -gz;
  pg[5] = gmu;
}

}  // namespace
