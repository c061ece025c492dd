// Device code of the df32 ("double-single") kernels K10-K13, compiled
// per plan key (df32_spec.cuh): the packed step layout and flag bits,
// the error-free transforms and df32 arithmetic, one surface step, and
// the ray loads, stores and moment sums.
//
// Every float32 operation is written with a round-to-nearest intrinsic
// (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn), which nvcc
// never contracts into a fused multiply-add, so each rounds where the
// plain version (ops/df32.py) rounds; that holds whatever the build
// flags.  Division and square root are correctly rounded, as the plain
// version's.
//
// two_prod takes its FMA form: p = __fmul_rn(a, b), e = __fmaf_rn(a, b,
// -p), 2 operations where the plain version's Dekker split takes 17.
// Both give the exact error word a*b - p wherever neither underflows,
// so both give the plain version's words.  Every other operation keeps
// its unfused intrinsic.

#pragma once

#include "trace_common.cuh"

namespace {

// packed step layout: keep in sync with cuda_df32.py (DW, W_*)
constexpr int DW = 36;
constexpr int W_C = 0;     // curvature
constexpr int W_MU = 2;    // |mu|
constexpr int W_DZ = 4;    // offset z
constexpr int W_K1 = 6;    // 1 + conic
constexpr int W_K1C = 8;   // (1 + conic) * curvature
constexpr int W_DXY = 10;  // offset x, y
constexpr int W_ROT = 14;  // rot, row-major 3x3 pairs
constexpr int W_RAD = 32;  // squared aperture radius (one float)
constexpr int W_NB = 33;   // n_before

// flag bits: keep in sync with cuda_df32.py (G_*)
constexpr int G_KIND = 3;          // 0 pass, 1 refract, 2 mirror
constexpr int G_FLAT = 1 << 2;
constexpr int G_CONIC = 1 << 3;
constexpr int G_ALTERNATE = 1 << 4;
constexpr int G_OFF_AXIS = 1 << 5;
constexpr int G_PERM = 1 << 6;     // exact signed-permutation fold
constexpr int G_ROT = 1 << 7;      // general df32 rotation
constexpr int G_CLIP = 1 << 8;
constexpr int G_FAST = 1 << 9;
constexpr int G_PERM_SHIFT = 10;   // 3 bits a row: column (2), negate (1)

struct df {
  float hi, lo;
};

__device__ __forceinline__ float fa(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fs(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fm(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fd(float a, float b) { return __fdiv_rn(a, b); }

// -- error-free transforms ---------------------------------------------------

__device__ __forceinline__ df two_sum(float a, float b) {
  const float s = fa(a, b);
  const float bb = fs(s, a);
  return {s, fa(fs(a, fs(s, bb)), fs(b, bb))};
}

__device__ __forceinline__ df quick_two_sum(float a, float b) {
  const float s = fa(a, b);
  return {s, fs(b, fs(s, a))};
}

__device__ __forceinline__ df two_prod(float a, float b) {
  const float p = fm(a, b);
  return {p, __fmaf_rn(a, b, -p)};
}

// -- df32 arithmetic ----------------------------------------------------------

__device__ __forceinline__ df neg(df a) { return {-a.hi, -a.lo}; }

__device__ __forceinline__ df add(df a, df b) {
  const df s = two_sum(a.hi, b.hi);
  return quick_two_sum(s.hi, fa(s.lo, fa(a.lo, b.lo)));
}

__device__ __forceinline__ df sub(df a, df b) { return add(a, neg(b)); }

__device__ __forceinline__ df mul(df a, df b) {
  const df p = two_prod(a.hi, b.hi);
  return quick_two_sum(p.hi, fa(p.lo, fa(fm(a.hi, b.lo), fm(a.lo, b.hi))));
}

__device__ __forceinline__ df sqr(df a) {
  const df p = two_prod(a.hi, a.hi);
  return quick_two_sum(p.hi, fa(p.lo, fm(2.f, fm(a.hi, a.lo))));
}

__device__ __forceinline__ df scale(df a, float s) {
  return {fm(a.hi, s), fm(a.lo, s)};
}

// two refinement rounds (exact plan) or one (fast plan)
__device__ __forceinline__ df div2(df a, df b) {
  const float q1 = fd(a.hi, b.hi);
  df r = sub(a, mul({q1, 0.f}, b));
  const df q = quick_two_sum(q1, fd(fa(r.hi, r.lo), b.hi));
  r = sub(a, mul(q, b));
  return add(q, {fd(fa(r.hi, r.lo), b.hi), 0.f});
}

__device__ __forceinline__ df div1(df a, df b) {
  const float q1 = fd(a.hi, b.hi);
  const df r = sub(a, mul({q1, 0.f}, b));
  return quick_two_sum(q1, fd(fa(r.hi, r.lo), b.hi));
}

// Karp-Markstein rounds from the correctly rounded float32 root; NaN for
// a negative hi word, on purpose
__device__ __forceinline__ df sqrt2(df a) {
  const float s1 = __fsqrt_rn(a.hi);
  const float inv2 = s1 > 0.f ? fd(0.5f, s1) : 0.f;
  df r = sub(a, sqr({s1, 0.f}));
  const df s = quick_two_sum(s1, fm(fa(r.hi, r.lo), inv2));
  r = sub(a, sqr(s));
  return add(s, {fm(fa(r.hi, r.lo), inv2), 0.f});
}

__device__ __forceinline__ df sqrt1(df a) {
  const float s1 = __fsqrt_rn(a.hi);
  const float inv2 = s1 > 0.f ? fd(0.5f, s1) : 0.f;
  const df r = sub(a, sqr({s1, 0.f}));
  return quick_two_sum(s1, fm(fa(r.hi, r.lo), inv2));
}

__device__ __forceinline__ df dv(df a, df b, bool fast) {
  return fast ? div1(a, b) : div2(a, b);
}

__device__ __forceinline__ df sq(df a, bool fast) {
  return fast ? sqrt1(a) : sqrt2(a);
}

__device__ __forceinline__ df dot3(df ax, df ay, df az, df bx, df by,
                                   df bz) {
  return add(add(mul(ax, bx), mul(ay, by)), mul(az, bz));
}

// a step's words: a pointer into the kernel's parameters, or a volatile
// one into their shared-memory copy (read where each word is used)
template <typename W>
__device__ __forceinline__ df ld(W w, int i) {
  return {w[i], w[i + 1]};
}

// -- frame changes ------------------------------------------------------------

__device__ __forceinline__ df pick(int col, df x, df y, df z) {
  return col == 0 ? x : (col == 1 ? y : z);
}

// v <- R v for the step's signed permutation (exact: swaps and flips)
__device__ __forceinline__ void perm_apply(int fl, df& x, df& y, df& z) {
  df o[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int code = (fl >> (G_PERM_SHIFT + 3 * r)) & 7;
    const df v = pick(code & 3, x, y, z);
    o[r] = (code & 4) ? neg(v) : v;
  }
  x = o[0]; y = o[1]; z = o[2];
}

// v <- R^T v: component r of v lands, signed, in its row's column
__device__ __forceinline__ void perm_apply_t(int fl, df& x, df& y, df& z) {
  const df v[3] = {x, y, z};
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int code = (fl >> (G_PERM_SHIFT + 3 * r)) & 7;
    const df s = (code & 4) ? neg(v[r]) : v[r];
    const int col = code & 3;
    if (col == 0) x = s;
    else if (col == 1) y = s;
    else z = s;
  }
}

// v <- R v (T = false) or R^T v (T = true) with R the step's df32 matrix
template <bool T, typename W>
__device__ __forceinline__ void rot_apply_df(W w, df& x, df& y, df& z) {
  df o[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int i0 = T ? r : 3 * r, st = T ? 3 : 1;
    df acc = mul(ld(w, W_ROT + 2 * i0), x);
    acc = add(acc, mul(ld(w, W_ROT + 2 * (i0 + st)), y));
    acc = add(acc, mul(ld(w, W_ROT + 2 * (i0 + 2 * st)), z));
    o[r] = acc;
  }
  x = o[0]; y = o[1]; z = o[2];
}

// v <- the step's frame change (R v) or its inverse (R^T v, T = true)
template <bool T, typename W>
__device__ __forceinline__ void frame_apply(W w, int fl, df& x, df& y,
                                            df& z) {
  if (fl & G_PERM) {
    if (T) perm_apply_t(fl, x, y, z);
    else perm_apply(fl, x, y, z);
  } else if (fl & G_ROT) {
    rot_apply_df<T>(w, x, y, z);
  }
}

// -- one step -----------------------------------------------------------------

// One transfer-intercept-refract step (ops/df32._surface_df): state in
// and out in the running frame, s the intercept distance.  The step's
// flags arrive as std::integral_constant<int, F> (df32_spec.cuh): every
// `fl & G_*` below, the permutation codes and the fast/exact choice are
// constants and the branches not taken fold away.
template <typename Flags, typename W>
__device__ __forceinline__ void surface_df(W w, Flags flags, df& x, df& y,
                                           df& z, df& ux, df& uy, df& uz,
                                           df& s) {
  const int fl = flag_value(flags);
  const bool fast = fl & G_FAST;
  const bool flat = fl & G_FLAT;
  const bool conic = fl & G_CONIC;
  const df one = {1.f, 0.f};
  z = sub(z, ld(w, W_DZ));
  if (fl & G_OFF_AXIS) {
    x = sub(x, ld(w, W_DXY));
    y = sub(y, ld(w, W_DXY + 2));
  }
  frame_apply<false>(w, fl, x, y, z);
  frame_apply<false>(w, fl, ux, uy, uz);
  const df c = ld(w, W_C);
  if (flat) {
    s = neg(dv(z, uz, fast));
  } else {
    // closed-form conic intercept; the two root forms -(d+g)/e and
    // f/(g-d) are each stable in the complementary sign regime of d
    df uy_, yy, e_q;
    if (conic) {
      const df k1 = ld(w, W_K1);
      const df kz = mul(k1, z);
      uy_ = dot3(ux, uy, uz, x, y, kz);
      const df uu = add(add(sqr(ux), sqr(uy)), mul(k1, sqr(uz)));
      yy = dot3(x, y, z, x, y, kz);
      e_q = mul(c, uu);
    } else {
      uy_ = dot3(ux, uy, uz, x, y, z);
      yy = dot3(x, y, z, x, y, z);
      e_q = c;
    }
    const df d = sub(mul(c, uy_), uz);
    const df f = sub(mul(c, yy), scale(z, 2.f));
    const df disc = sub(sqr(d), mul(e_q, f));
    const df g = sq(disc, fast);
    if (fl & G_ALTERNATE) {
      s = dv(neg(sub(d, g)), e_q, fast);
    } else {
      const bool stable = d.hi < 0.f;  // false for NaN, as torch.where
      const df num = stable ? f : neg(add(d, g));
      const df den = stable ? sub(g, d) : e_q;
      s = dv(num, den, fast);
    }
  }
  x = add(x, mul(s, ux));
  y = add(y, mul(s, uy));
  z = add(z, mul(s, uz));
  if (fl & G_CLIP) {
    // aperture clip on the hi words: NaN the direction outside
    if (fa(fm(x.hi, x.hi), fm(y.hi, y.hi)) > w[W_RAD]) {
      const float nan = qnan<float>();
      ux = uy = uz = df{nan, nan};
    }
  }
  const int kind = fl & G_KIND;
  if (kind != 0) {
    // polynomial implicit-gradient normal N = (-c x, -c y, 1 - c(1+k) z);
    // |N| == 1 exactly on a sphere (unit)
    df nx, ny, nzv, dot, nn;
    const bool unit = !conic || flat;
    if (!flat) {
      nx = neg(mul(c, x));
      ny = neg(mul(c, y));
      nzv = sub(one, mul(conic ? ld(w, W_K1C) : c, z));
      dot = add(add(mul(ux, nx), mul(uy, ny)), mul(uz, nzv));
      if (conic) nn = add(add(sqr(nx), sqr(ny)), sqr(nzv));
    } else {
      dot = uz;
    }
    if (kind == 2) {
      const df a2 = unit ? scale(dot, 2.f) : scale(dv(dot, nn, fast), 2.f);
      if (flat) {
        uz = sub(uz, a2);
      } else {
        ux = sub(ux, mul(a2, nx));
        uy = sub(uy, mul(a2, ny));
        uz = sub(uz, mul(a2, nzv));
      }
    } else {
      const df mu = ld(w, W_MU);
      const df b0 = sub(sqr(mu), one);
      df a, b;
      if (unit) {
        a = mul(mu, dot);
        b = b0;
      } else {
        const df inv_nn = dv(one, nn, fast);
        a = mul(mul(mu, dot), inv_nn);
        b = mul(b0, inv_nn);
      }
      const df g = sub(sq(sub(sqr(a), b), fast), a);
      if (flat) {
        ux = mul(mu, ux);
        uy = mul(mu, uy);
        uz = add(mul(mu, uz), g);
      } else {
        ux = add(mul(mu, ux), mul(g, nx));
        uy = add(mul(mu, uy), mul(g, ny));
        uz = add(mul(mu, uz), mul(g, nzv));
      }
    }
  }
  frame_apply<true>(w, fl, x, y, z);
  frame_apply<true>(w, fl, ux, uy, uz);
}

// -- rays in and out, moments -------------------------------------------------

struct Rays {
  df x, y, z, ux, uy, uz;
};

// The 12 input words, one pointer each: x hi, x lo, y hi, ..., uz lo.
struct In12 {
  const float* p[12];
};

__device__ __forceinline__ Rays load_rays(const In12& in, int64_t i) {
  return {{in.p[0][i], in.p[1][i]}, {in.p[2][i], in.p[3][i]},
          {in.p[4][i], in.p[5][i]}, {in.p[6][i], in.p[7][i]},
          {in.p[8][i], in.p[9][i]}, {in.p[10][i], in.p[11][i]}};
}

__device__ __forceinline__ void store_rays(float* o, int64_t n, int64_t i,
                                           const Rays& r, const df* tacc) {
  const df c[6] = {r.x, r.y, r.z, r.ux, r.uy, r.uz};
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    o[(2 * k) * n + i] = c[k].hi;
    o[(2 * k + 1) * n + i] = c[k].lo;
  }
  if (tacc) {
    o[12 * n + i] = tacc->hi;
    o[13 * n + i] = tacc->lo;
  }
}

// The launchers' 12 input pointers as the kernels take them.
__host__ inline In12 pack_in(const void* const* p) {
  In12 in;
  for (int k = 0; k < 12; ++k) in.p[k] = static_cast<const float*>(p[k]);
  return in;
}

// The moments a ray adds (count, x, y, x^2, y^2), or nothing when x, y
// or uz is not finite (a masked ray adds exact zeros in the plain
// version: the same df32 sum).
__device__ __forceinline__ bool live(const Rays& r) {
  return isfinite(r.x.hi) && isfinite(r.y.hi) && isfinite(r.uz.hi);
}

__device__ __forceinline__ void accumulate(df* m, int stride, const Rays& r) {
  m[0] = add(m[0], df{1.f, 0.f});
  m[stride] = add(m[stride], r.x);
  m[2 * stride] = add(m[2 * stride], r.y);
  m[3 * stride] = add(m[3 * stride], mul(r.x, r.x));
  m[4 * stride] = add(m[4 * stride], mul(r.y, r.y));
}

// Block sum of each thread's five df32 moments: warp shuffles, then the
// first warp over the warps' sums; thread 0 writes 10 words (hi, lo a
// moment) to out.  scratch holds 10 floats a warp.  Every thread of the
// block calls it; blockDim.x is a multiple of 32.
__device__ __forceinline__ void block_sum_df(df m[5], float* scratch,
                                             float* out) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int q = 0; q < 5; ++q)
      m[q] = add(m[q], df{__shfl_down_sync(full, m[q].hi, off),
                          __shfl_down_sync(full, m[q].lo, off)});
  if (lane == 0)
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      scratch[warp * 10 + 2 * q] = m[q].hi;
      scratch[warp * 10 + 2 * q + 1] = m[q].lo;
    }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int q = 0; q < 5; ++q)
      m[q] = lane < nwarps ? df{scratch[lane * 10 + 2 * q],
                                scratch[lane * 10 + 2 * q + 1]}
                           : df{0.f, 0.f};
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int q = 0; q < 5; ++q)
        m[q] = add(m[q], df{__shfl_down_sync(full, m[q].hi, off),
                            __shfl_down_sync(full, m[q].lo, off)});
    if (lane == 0)
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        out[2 * q] = m[q].hi;
        out[2 * q + 1] = m[q].lo;
      }
  }
  __syncthreads();  // scratch is reused by the next call
}

}  // namespace

// A launcher's 12 input words (x hi, x lo, ..., uz lo) and their array.
#define IN12_PARAMS                                                           \
  const void *xh, const void *xl, const void *yh, const void *yl,            \
      const void *zh, const void *zl, const void *uxh, const void *uxl,      \
      const void *uyh, const void *uyl, const void *uzh, const void *uzl
#define IN12_ARRAY {xh, xl, yh, yl, zh, zl, uxh, uxl, uyh, uyl, uzh, uzl}
