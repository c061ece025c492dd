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

// packed step layout: keep in sync with cuda_df32.py (DW, W_*, A_*)
constexpr int DW = 36;     // the words of a step without a figure
constexpr int W_C = 0;     // curvature
constexpr int W_MU = 2;    // |mu|
constexpr int W_DZ = 4;    // offset z
constexpr int W_K1 = 6;    // 1 + conic
constexpr int W_K1C = 8;   // (1 + conic) * curvature
constexpr int W_DXY = 10;  // offset x, y
constexpr int W_ROT = 14;  // rot, row-major 3x3 pairs
constexpr int W_RAD = 32;  // squared aperture radius (one float)
constexpr int W_NB = 33;   // n_before
constexpr int W_FIG = DW;  // a figure's words, by its row kind:
// an aspheric row: its even, then odd coefficients (pairs);
// a conic cylinder: c1, 1 + k, (1 + k) c1 (pairs), and on a phase row
// (1 + k) c1^2 (a pair, its normal's);
// a biconic or toroid: cx, cy, cr, (1 + kx) cx^2, (1 + ky) cy^2 (pairs),
// the seed's float32 kx and ky, then the even and odd coefficients
// (pairs; the seed reads their hi words, and those of cx, cy and cr);
// a freeform row (the base's c and 1 + conic are W_C and W_K1): the
// seed's float32 conic, the base's even and odd coefficients (pairs),
// then the XY figure's value terms a, x-slope terms i a and y-slope terms
// j a (pairs, in term order; xy_terms);
// then a phase row's words (phase_at): grating_dy (a pair, G_GRATING),
// the DOE's kick coefficients 2 (i + 1) a_i and its path coefficients
// a_i n_after / n_before (nd pairs each, G_DOE)
constexpr int A_C1 = 0, A_K1 = 2, A_K1C = 4, A_BC = 6, CYL_WORDS = 6;
constexpr int A_CX = 0, A_CY = 2, A_CR = 4, A_BXC = 6, A_BYC = 8, A_KX = 10,
              A_KY = 11, A_COEF = 12;
constexpr int F_KY = 0, F_COEF = 1;

// flag bits of a step's 64-bit flag word: keep in sync with cuda_df32.py
// (G_*)
using Flag = long long;
constexpr Flag G_KIND = 3;          // 0 pass, 1 refract, 2 mirror
constexpr Flag G_FLAT = 1LL << 2;
constexpr Flag G_CONIC = 1LL << 3;
constexpr Flag G_ALTERNATE = 1LL << 4;
constexpr Flag G_OFF_AXIS = 1LL << 5;
constexpr Flag G_PERM = 1LL << 6;   // exact signed-permutation fold
constexpr Flag G_ROT = 1LL << 7;    // general df32 rotation
constexpr Flag G_CLIP = 1LL << 8;
constexpr Flag G_FAST = 1LL << 9;
constexpr int G_PERM_SHIFT = 10;    // 3 bits a row: column (2), negate (1)
constexpr int G_FIG_SHIFT = 19;     // 3 bits: the row kind (FIG_*)
constexpr int G_NA_SHIFT = 22;      // 4 bits: even coefficients
constexpr int G_NO_SHIFT = 26;      // 4 bits: odd coefficients
constexpr Flag G_CYL_CONIC = 1LL << 30;  // a conic cylinder: |N| is not 1
constexpr Flag G_GRATING = 1LL << 31;    // a linear grating: grating_dy
constexpr Flag G_DOE = 1LL << 32;        // a radial diffractive phase
constexpr int G_ND_SHIFT = 33;           // 4 bits: its coefficients
constexpr Flag G_PHASE = G_GRATING | G_DOE;
// bits 37-63: a freeform row's XY terms, one bit a term of the triangular
// order (FIG_FREEFORM, up to XY_MASK_TERMS: degree 6), or the degree of
// a dense row (FIG_XY_DENSE: every term of the degree, zeros included)
constexpr int G_XY_SHIFT = 37;
constexpr int XY_MASK_TERMS = 27;
constexpr int FIG_NONE = 0, FIG_RADIAL = 1, FIG_CYL_Y = 2, FIG_CYL_X = 3,
              FIG_BICONIC = 4, FIG_TOROID = 5, FIG_FREEFORM = 6,
              FIG_XY_DENSE = 7;

__host__ __device__ constexpr int fig_of(Flag fl) {
  return int((fl >> G_FIG_SHIFT) & 7);
}
__host__ __device__ constexpr int na_of(Flag fl) {
  return int((fl >> G_NA_SHIFT) & 15);
}
__host__ __device__ constexpr int no_of(Flag fl) {
  return int((fl >> G_NO_SHIFT) & 15);
}
__host__ __device__ constexpr int nd_of(Flag fl) {
  return int((fl >> G_ND_SHIFT) & 15);
}

// -- a freeform row's XY terms (cuda_df32.xy_terms) ---------------------------
//
// Term t of the triangular order (xy_term_i, xy_term_j: trace_common.cuh)
// has a value term (a, i, j), an x-slope term (i a, i - 1, j) where i > 0
// and a y-slope term (j a, i, j - 1) where j > 0 (KIND 0, 1, 2).

__host__ __device__ constexpr bool freeform_fig(int fig) {
  return fig == FIG_FREEFORM || fig == FIG_XY_DENSE;
}

// the mask (FIG_FREEFORM) or the degree (FIG_XY_DENSE)
__host__ __device__ constexpr long long xy_field(Flag fl) {
  return (fl >> G_XY_SHIFT) & ((1LL << (64 - G_XY_SHIFT)) - 1);
}

// the terms t < xy_slots whose words a step holds
__host__ __device__ constexpr int xy_slots(Flag fl) {
  return fig_of(fl) == FIG_XY_DENSE
             ? int(xy_field(fl) * (xy_field(fl) + 3) / 2)
             : fig_of(fl) == FIG_FREEFORM ? XY_MASK_TERMS : 0;
}

__host__ __device__ constexpr bool xy_holds(Flag fl, int t, int kind) {
  return t < xy_slots(fl) &&
         (fig_of(fl) == FIG_XY_DENSE || ((xy_field(fl) >> t) & 1)) &&
         (kind == 0 || (kind == 1 ? xy_term_i(t) > 0 : xy_term_j(t) > 0));
}

// the pairs of kind before term t (t = xy_slots: all of them)
__host__ __device__ constexpr int xy_rank(Flag fl, int t, int kind) {
  int r = 0;
  for (int q = 0; q < t; ++q) r += xy_holds(fl, q, kind);
  return r;
}

// the highest total degree of the step's terms
__host__ __device__ constexpr int xy_top(Flag fl) {
  int d = 0;
  for (int t = 0; t < xy_slots(fl); ++t)
    if (xy_holds(fl, t, 0) && xy_term_d(t) > d) d = xy_term_d(t);
  return d;
}

// the first word of the step's pairs of kind
__host__ __device__ constexpr int xy_at(Flag fl, int kind) {
  int at = DW + F_COEF + 2 * (na_of(fl) + no_of(fl));
  for (int k = 0; k < kind; ++k) at += 2 * xy_rank(fl, xy_slots(fl), k);
  return at;
}

// The first word of a step's phase words: DW and its figure's.
__host__ __device__ constexpr int phase_at(Flag fl) {
  const int fig = fig_of(fl), coef = 2 * (na_of(fl) + no_of(fl));
  return freeform_fig(fig) ? xy_at(fl, 3)
         : DW + (fig == FIG_RADIAL ? coef
                 : fig == FIG_CYL_Y || fig == FIG_CYL_X
                     ? CYL_WORDS + ((fl & G_PHASE) ? 2 : 0)
                 : fig == FIG_BICONIC || fig == FIG_TOROID ? A_COEF + coef
                 : 0);
}

// The words of a step: DW, its figure's and its phase words
// (cuda_df32.step_words).
__host__ __device__ constexpr int step_words(Flag fl) {
  return phase_at(fl) + ((fl & G_GRATING) ? 2 : 0) +
         ((fl & G_DOE) ? 4 * nd_of(fl) : 0);
}

// the Newton's rounds and its residual test (ops/df32.py)
constexpr int DF_ASPHERIC_ITERS = 8;
constexpr int ANAM_F32_ITERS = 6;
constexpr int ANAM_DF_ITERS = 2;   // 3 in the exact plan

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
__device__ __forceinline__ void perm_apply(Flag fl, df& x, df& y, df& z) {
  df o[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int code = int((fl >> (G_PERM_SHIFT + 3 * r)) & 7);
    const df v = pick(code & 3, x, y, z);
    o[r] = (code & 4) ? neg(v) : v;
  }
  x = o[0]; y = o[1]; z = o[2];
}

// v <- R^T v: component r of v lands, signed, in its row's column
__device__ __forceinline__ void perm_apply_t(Flag fl, df& x, df& y, df& z) {
  const df v[3] = {x, y, z};
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int code = int((fl >> (G_PERM_SHIFT + 3 * r)) & 7);
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
__device__ __forceinline__ void frame_apply(W w, Flag fl, df& x, df& y,
                                            df& z) {
  if (fl & G_PERM) {
    if (T) perm_apply_t(fl, x, y, z);
    else perm_apply(fl, x, y, z);
  } else if (fl & G_ROT) {
    rot_apply_df<T>(w, x, y, z);
  }
}

// -- figures in df32 (ops/df32.py) ------------------------------------------
//
// A figure's coefficients are read from the step's words where they are
// used: N pairs at w[at], N a compile-time count (the step's flags).

constexpr float TINY32 = static_cast<float>(1e-30);
constexpr float NEWTON_TOL = static_cast<float>(1e-9);

// the pair floored at TINY32 on its hi word; NaN floors too (_max_tiny)
__device__ __forceinline__ df max_tiny(df a) {
  return a.hi > TINY32 ? a : df{TINY32, 0.f};
}

// sum c_i r2^(i+1) by Horner (_poly_even_df)
template <int N, typename W>
__device__ __forceinline__ df poly_even_df(df r2, W w, int at) {
  df acc = ld(w, at + 2 * (N - 1));
#pragma unroll
  for (int i = N - 2; i >= 0; --i) acc = add(mul(acc, r2), ld(w, at + 2 * i));
  return mul(acc, r2);
}

// sum 2(i+1) c_i r2^i (_dpoly_even_df)
template <int N, typename W>
__device__ __forceinline__ df dpoly_even_df(df r2, W w, int at) {
  df acc = scale(ld(w, at + 2 * (N - 1)), float(2 * N));
#pragma unroll
  for (int i = N - 2; i >= 0; --i)
    acc = add(mul(acc, r2), scale(ld(w, at + 2 * i), float(2 * (i + 1))));
  return acc;
}

// sum c_j r^(2j+1), r = sqrt(r2) given (_poly_odd_df)
template <int N, typename W>
__device__ __forceinline__ df poly_odd_df(df r2, df r, W w, int at) {
  df acc = ld(w, at + 2 * (N - 1));
#pragma unroll
  for (int j = N - 2; j >= 0; --j) acc = add(mul(acc, r2), ld(w, at + 2 * j));
  return mul(r, acc);
}

// P(r2)/r + 2 r P'(r2), the cusp floored (_dpoly_odd_df)
template <int N, typename W>
__device__ __forceinline__ df dpoly_odd_df(df r2, df r, W w, int at,
                                           bool fast) {
  df p = ld(w, at + 2 * (N - 1));
#pragma unroll
  for (int j = N - 2; j >= 0; --j) p = add(mul(p, r2), ld(w, at + 2 * j));
  df out = dv(p, max_tiny(r), fast);
  if constexpr (N > 1) {
    df dp = scale(ld(w, at + 2 * (N - 1)), float(N - 1));
#pragma unroll
    for (int j = N - 2; j >= 1; --j)
      dp = add(mul(dp, r2), scale(ld(w, at + 2 * j), float(j)));
    out = add(out, scale(mul(r, dp), 2.f));
  }
  return out;
}

// e - the even and odd figure at r2 (NA, then NO pairs at w[at])
template <int NA, int NO, typename W>
__device__ __forceinline__ df less_figure_df(df e, df r2, W w, int at,
                                             bool fast) {
  if constexpr (NA > 0) e = sub(e, poly_even_df<NA>(r2, w, at));
  if constexpr (NO > 0)
    e = sub(e, poly_odd_df<NO>(r2, sq(r2, fast), w, at + 2 * NA));
  return e;
}

// z - sag of an aspheric row (_sag_df), its figure at w[AT]
template <int NA, int NO, int AT = W_FIG, typename W>
__device__ __forceinline__ df sag_df(W w, df x, df y, df z, df c, df k1,
                                     bool fast) {
  const df one = {1.f, 0.f};
  const df r2 = add(sqr(x), sqr(y));
  const df cr2 = mul(c, r2);
  const df den = add(one, sq(sub(one, mul(k1, mul(c, cr2))), fast));
  return less_figure_df<NA, NO>(sub(z, dv(cr2, den, fast)), r2, w, AT, fast);
}

// the radial factor e of an aspheric row's normal (x e, y e, 1)
// (_normal_radial_df), its figure at w[AT]
template <int NA, int NO, int AT = W_FIG, typename W>
__device__ __forceinline__ df normal_radial_df(W w, df x, df y, df c, df k1,
                                               bool fast) {
  const df one = {1.f, 0.f};
  const df r2 = add(sqr(x), sqr(y));
  df e = neg(dv(c, sq(sub(one, mul(k1, mul(sqr(c), r2))), fast), fast));
  if constexpr (NA > 0) e = sub(e, dpoly_even_df<NA>(r2, w, AT));
  if constexpr (NO > 0)
    e = sub(e, dpoly_odd_df<NO>(r2, sq(r2, fast), w, AT + 2 * NA, fast));
  return e;
}

// z - biconic sag (_sag_biconic_df)
template <int NA, int NO, typename W>
__device__ __forceinline__ df sag_biconic_df(W w, df x, df y, df z,
                                             bool fast) {
  const df one = {1.f, 0.f};
  const df x2 = sqr(x), y2 = sqr(y);
  const df a = add(mul(ld(w, W_FIG + A_CX), x2), mul(ld(w, W_FIG + A_CY), y2));
  const df b = add(mul(ld(w, W_FIG + A_BXC), x2),
                   mul(ld(w, W_FIG + A_BYC), y2));
  const df e = sub(z, dv(a, add(one, sq(sub(one, b), fast)), fast));
  return less_figure_df<NA, NO>(e, add(x2, y2), w, W_FIG + A_COEF, fast);
}

// (gx, gy) of the biconic normal (_normal_biconic_df)
template <int NA, int NO, typename W>
__device__ __forceinline__ void normal_biconic_df(W w, df x, df y, bool fast,
                                                  df& gx, df& gy) {
  const df one = {1.f, 0.f};
  const df cx = ld(w, W_FIG + A_CX), cy = ld(w, W_FIG + A_CY);
  const df bxc = ld(w, W_FIG + A_BXC), byc = ld(w, W_FIG + A_BYC);
  const df x2 = sqr(x), y2 = sqr(y);
  const df a = add(mul(cx, x2), mul(cy, y2));
  const df b = add(mul(bxc, x2), mul(byc, y2));
  const df s = sq(sub(one, b), fast);
  const df one_s = add(one, s);
  const df inv2 = sqr(dv(one, one_s, fast));
  const df a_s = dv(a, max_tiny(s), fast);
  gx = neg(mul(x, mul(add(scale(mul(cx, one_s), 2.f), mul(a_s, bxc)), inv2)));
  gy = neg(mul(y, mul(add(scale(mul(cy, one_s), 2.f), mul(a_s, byc)), inv2)));
  if constexpr (NA > 0 || NO > 0) {
    constexpr int at = W_FIG + A_COEF;
    const df r2 = add(x2, y2);
    df d;
    if constexpr (NA > 0) d = dpoly_even_df<NA>(r2, w, at);
    if constexpr (NO > 0) {
      const df dodd = dpoly_odd_df<NO>(r2, sq(r2, fast), w, at + 2 * NA, fast);
      d = NA > 0 ? add(d, dodd) : dodd;
    }
    gx = sub(gx, mul(x, d));
    gy = sub(gy, mul(y, d));
  }
}

// (zy, dzy/dy) of the toroid's generating curve (_ycurve_df)
template <int NA, int NO, typename W>
__device__ __forceinline__ void ycurve_df(W w, df y, bool fast, df& zy,
                                          df& dzy) {
  const df one = {1.f, 0.f};
  const df cy = ld(w, W_FIG + A_CY);
  const df y2 = sqr(y);
  const df sqv = sq(sub(one, mul(ld(w, W_FIG + A_BYC), y2)), fast);
  zy = dv(mul(cy, y2), add(one, sqv), fast);
  dzy = dv(mul(cy, y), max_tiny(sqv), fast);
  constexpr int at = W_FIG + A_COEF;
  if constexpr (NA > 0) {
    zy = add(zy, poly_even_df<NA>(y2, w, at));
    dzy = add(dzy, mul(y, dpoly_even_df<NA>(y2, w, at)));
  }
  if constexpr (NO > 0) {
    const df ya = sq(y2, fast);
    zy = add(zy, poly_odd_df<NO>(y2, ya, w, at + 2 * NA));
    dzy = add(dzy, mul(y, dpoly_odd_df<NO>(y2, ya, w, at + 2 * NA, fast)));
  }
}

// z - toroidal sag (_sag_toroid_df)
template <int NA, int NO, typename W>
__device__ __forceinline__ df sag_toroid_df(W w, df x, df y, df z,
                                            bool fast) {
  const df one = {1.f, 0.f};
  const df cr = ld(w, W_FIG + A_CR);
  df zy, dzy;
  ycurve_df<NA, NO>(w, y, fast, zy, dzy);
  const df crp = dv(cr, sub(one, mul(cr, zy)), fast);
  const df x2 = sqr(x);
  const df wr = sq(sub(one, mul(x2, sqr(crp))), fast);
  return sub(sub(z, zy), dv(mul(crp, x2), add(one, wr), fast));
}

// (gx, gy) of the toroid normal (_normal_toroid_df)
template <int NA, int NO, typename W>
__device__ __forceinline__ void normal_toroid_df(W w, df x, df y, bool fast,
                                                 df& gx, df& gy) {
  const df one = {1.f, 0.f};
  const df cr = ld(w, W_FIG + A_CR);
  df zy, dzy;
  ycurve_df<NA, NO>(w, y, fast, zy, dzy);
  const df crp = dv(cr, sub(one, mul(cr, zy)), fast);
  const df wr = max_tiny(sq(sub(one, mul(sqr(x), sqr(crp))), fast));
  gx = neg(dv(mul(x, crp), wr, fast));
  gy = neg(dv(dzy, wr, fast));
}

// p = [-, v, v^2, ..., v^D] by repeated df32 products (_xy_pows_df)
template <int D>
__device__ __forceinline__ void xy_pows_df(df v, df* p) {
  if constexpr (D > 0) p[1] = v;
#pragma unroll
  for (int d = 2; d <= D; ++d) p[d] = mul(p[d - 1], v);
}

// The XY figure's terms of KIND (0 value, 1 x slope, 2 y slope) in df32
// (_poly_xy_df): each term the step holds, in term order, its pair read
// where it is used; a (0, 0) exponent is the constant itself; the sum
// starts from the first.  The terms are a compile-time list (xy_holds):
// no other term costs anything.  At least one term.
template <Flag FL, int KIND, typename W>
__device__ __forceinline__ df poly_xy_df(W w, const df* xp, const df* yp) {
  df acc;
  static_for(std::make_integer_sequence<int, xy_slots(FL)>{}, [&](auto tc) {
    constexpr int t = decltype(tc)::value;
    if constexpr (xy_holds(FL, t, KIND)) {
      constexpr int i = xy_term_i(t) - (KIND == 1);
      constexpr int j = xy_term_j(t) - (KIND == 2);
      constexpr int r = xy_rank(FL, t, KIND);
      const df cdf = ld(w, xy_at(FL, KIND) + 2 * r);
      df term;
      if constexpr (i == 0 && j == 0) {
        term = cdf;
      } else {
        df m;
        if constexpr (i > 0) m = xp[i];
        else m = yp[j];
        if constexpr (i > 0 && j > 0) m = mul(m, yp[j]);
        term = mul(cdf, m);
      }
      if constexpr (r == 0) acc = term;
      else acc = add(acc, term);
    }
  });
  return acc;
}

// a freeform row's base 1 + conic: W_K1, or 1 exactly without a conic
template <Flag FL, typename W>
__device__ __forceinline__ df freeform_k1(W w) {
  if constexpr ((FL & G_CONIC) != 0) return ld(w, W_K1);
  else return df{1.f, 0.f};
}

// z - freeform sag (_sag_freeform_df): the base less the value terms
template <Flag FL, typename W>
__device__ __forceinline__ df sag_freeform_df(W w, df x, df y, df z,
                                              bool fast) {
  constexpr int D = xy_top(FL);
  df xp[D + 1], yp[D + 1];
  xy_pows_df<D>(x, xp);
  xy_pows_df<D>(y, yp);
  return sub(sag_df<na_of(FL), no_of(FL), W_FIG + F_COEF>(
                 w, x, y, z, ld(w, W_C), freeform_k1<FL>(w), fast),
             poly_xy_df<FL, 0>(w, xp, yp));
}

// (gx, gy) of the freeform normal (_normal_freeform_df): the base's
// radial factor times (x, y) less the slope terms
template <Flag FL, typename W>
__device__ __forceinline__ void normal_freeform_df(W w, df x, df y,
                                                   bool fast, df& gx,
                                                   df& gy) {
  constexpr int D = xy_top(FL);
  df xp[D + 1], yp[D + 1];
  xy_pows_df<D>(x, xp);
  xy_pows_df<D>(y, yp);
  const df e = normal_radial_df<na_of(FL), no_of(FL), W_FIG + F_COEF>(
      w, x, y, ld(w, W_C), freeform_k1<FL>(w), fast);
  gx = mul(x, e);
  gy = mul(y, e);
  if constexpr (xy_rank(FL, xy_slots(FL), 1) > 0)
    gx = sub(gx, poly_xy_df<FL, 1>(w, xp, yp));
  if constexpr (xy_rank(FL, xy_slots(FL), 2) > 0)
    gy = sub(gy, poly_xy_df<FL, 2>(w, xp, yp));
}

// the sag and normal of a Newton row of flags FL: a biconic, a toroid or
// a freeform row
template <Flag FL, typename W>
__device__ __forceinline__ df sag_anam_df(W w, df x, df y, df z, bool fast) {
  constexpr int FIG = fig_of(FL), NA = na_of(FL), NO = no_of(FL);
  if constexpr (freeform_fig(FIG))
    return sag_freeform_df<FL>(w, x, y, z, fast);
  else if constexpr (FIG == FIG_TOROID)
    return sag_toroid_df<NA, NO>(w, x, y, z, fast);
  else
    return sag_biconic_df<NA, NO>(w, x, y, z, fast);
}

template <Flag FL, typename W>
__device__ __forceinline__ void normal_anam_df(W w, df x, df y, bool fast,
                                               df& gx, df& gy) {
  constexpr int FIG = fig_of(FL), NA = na_of(FL), NO = no_of(FL);
  if constexpr (freeform_fig(FIG))
    normal_freeform_df<FL>(w, x, y, fast, gx, gy);
  else if constexpr (FIG == FIG_TOROID)
    normal_toroid_df<NA, NO>(w, x, y, fast, gx, gy);
  else
    normal_biconic_df<NA, NO>(w, x, y, fast, gx, gy);
}

// -- the float32 seed of the anamorphic Newton (ops/df32._*_32) -------------
//
// Plain float32, every operation rounded where the plain version rounds
// (the intrinsics, no contraction); the coefficients are the hi words of
// their pairs.

__device__ __forceinline__ float sqrt0_32(float x) {
  return __fsqrt_rn(x < 0.f ? 0.f : x);  // NaN stays NaN
}

__device__ __forceinline__ float max_tiny32(float x) {
  return x < TINY32 ? TINY32 : x;  // NaN stays NaN, as jnp.maximum
}

template <int N, typename W>
__device__ __forceinline__ float poly_even_32(float r2, W w, int at) {
  float d = 0.f;
#pragma unroll
  for (int i = N - 1; i >= 0; --i) d = fm(fa(d, w[at + 2 * i]), r2);
  return d;
}

template <int N, typename W>
__device__ __forceinline__ float dpoly_even_32(float r2, W w, int at) {
  float d = 0.f;
#pragma unroll
  for (int i = N - 1; i >= 0; --i)
    d = fa(fm(d, r2), fm(float(2 * (i + 1)), w[at + 2 * i]));
  return d;
}

template <int N, typename W>
__device__ __forceinline__ float poly_odd_32(float r2, W w, int at) {
  float d = 0.f;
#pragma unroll
  for (int j = N - 1; j >= 0; --j) d = fa(fm(d, r2), w[at + 2 * j]);
  return fm(__fsqrt_rn(r2), d);
}

template <int N, typename W>
__device__ __forceinline__ float dpoly_odd_32(float r2, W w, int at) {
  float p = 0.f, dp = 0.f;
#pragma unroll
  for (int j = N - 1; j >= 0; --j) p = fa(fm(p, r2), w[at + 2 * j]);
#pragma unroll
  for (int j = N - 1; j >= 1; --j)
    dp = fa(fm(dp, r2), fm(float(j), w[at + 2 * j]));
  const float r = max_tiny32(__fsqrt_rn(r2));
  return fa(fd(p, r), fm(fm(2.f, r), dp));
}

// kernels.intercept_conic in float32 (_intercept_conic_32)
__device__ __forceinline__ float intercept_conic_32(float x, float y, float z,
                                                    float ux, float uy,
                                                    float uz, float c,
                                                    float k, bool alt) {
  const float k1 = fa(1.f, k);
  const float uy_ = fa(fa(fm(ux, x), fm(uy, y)), fm(fm(k1, uz), z));
  const float uu = fa(fa(fm(ux, ux), fm(uy, uy)), fm(fm(k1, uz), uz));
  const float yy = fa(fa(fm(x, x), fm(y, y)), fm(fm(k1, z), z));
  const float d = fs(fm(c, uy_), uz);
  const float e = fm(c, uu);
  const float f = fs(fm(c, yy), fm(2.f, z));
  const float disc = fs(fm(d, d), fm(e, f));
  float g = sqrt0_32(disc);
  if (alt) g = -g;
  const bool conj = fm(d, g) <= 0.f || e == 0.f;
  const float num = conj ? f : -fa(d, g);
  float den = conj ? fs(g, d) : e;
  if (den == 0.f) den = 1.f;
  float s = fd(num, den);
  if (c == 0.f) s = fd(-z, uz == 0.f ? 1.f : uz);
  if (c != 0.f && disc < 0.f) s = qnan<float>();
  return s;
}

// the even and odd figure of a float32 sag at r2 (e - P)
template <int NA, int NO, typename W>
__device__ __forceinline__ float less_figure_32(float e, float r2, W w,
                                                int at) {
  if constexpr (NA > 0) e = fs(e, poly_even_32<NA>(r2, w, at));
  if constexpr (NO > 0) e = fs(e, poly_odd_32<NO>(r2, w, at + 2 * NA));
  return e;
}

// v^0 .. v^D by repeated float32 products (kernels._xy_pows)
template <int D>
__device__ __forceinline__ void xy_pows_32(float v, float* p) {
  if constexpr (D > 0) p[1] = v;
#pragma unroll
  for (int d = 2; d <= D; ++d) p[d] = fm(p[d - 1], v);
}

// A freeform row's float32 sag and normal (_sag_freeform_32,
// _normal_freeform_32: kernels.sag less kernels._poly_xy, and
// kernels.normal_freeform).  The coefficients are the hi words of the
// value pairs; the reference's seed also adds the row's zero terms,
// 0 * m, an exact zero on finite values: only the terms the step holds
// are added here.
template <Flag FL, typename W>
__device__ __forceinline__ void sag_normal_freeform_32(W w, float x, float y,
                                                       float z, float& fn,
                                                       float& gx, float& gy) {
  constexpr int NA = na_of(FL), NO = no_of(FL), D = xy_top(FL);
  constexpr int at = W_FIG + F_COEF;
  const float c = w[W_C];
  const float r2 = fa(fm(x, x), fm(y, y));
  const float root = sqrt0_32(
      fs(1.f, fm(fm(fm(fa(1.f, w[W_FIG + F_KY]), c), c), r2)));
  const float e = less_figure_32<NA, NO>(fs(z, fd(fm(c, r2), fa(1.f, root))),
                                         r2, w, at);
  float er = fd(-c, root);
  if constexpr (NA > 0) er = fs(er, dpoly_even_32<NA>(r2, w, at));
  if constexpr (NO > 0) er = fs(er, dpoly_odd_32<NO>(r2, w, at + 2 * NA));
  float xp[D + 1], yp[D + 1];
  xy_pows_32<D>(x, xp);
  xy_pows_32<D>(y, yp);
  float pv = 0.f, px = 0.f, py = 0.f;
  static_for(std::make_integer_sequence<int, xy_slots(FL)>{}, [&](auto tc) {
    constexpr int t = decltype(tc)::value;
    if constexpr (xy_holds(FL, t, 0)) {
      constexpr int i = xy_term_i(t), j = xy_term_j(t);
      const float a = w[xy_at(FL, 0) + 2 * xy_rank(FL, t, 0)];
      float m;
      if constexpr (i > 0) m = xp[i];
      else m = yp[j];
      if constexpr (i > 0 && j > 0) m = fm(m, yp[j]);
      pv = fa(pv, fm(a, m));
      // the slopes (i a) x^(i-1) y^j and (j a) y^(j-1) x^i, each
      // monomial's powers multiplied as kernels._dpoly_xy does
      if constexpr (i > 0) {
        const float ia = fm(float(i), a);
        if constexpr (i > 1 && j > 0)
          px = fa(px, fm(ia, fm(xp[i - 1], yp[j])));
        else if constexpr (i > 1) px = fa(px, fm(ia, xp[i - 1]));
        else if constexpr (j > 0) px = fa(px, fm(ia, yp[j]));
        else px = fa(px, ia);
      }
      if constexpr (j > 0) {
        const float ja = fm(float(j), a);
        if constexpr (j > 1 && i > 0)
          py = fa(py, fm(ja, fm(yp[j - 1], xp[i])));
        else if constexpr (j > 1) py = fa(py, fm(ja, yp[j - 1]));
        else if constexpr (i > 0) py = fa(py, fm(ja, xp[i]));
        else py = fa(py, ja);
      }
    }
  });
  fn = fs(e, pv);
  gx = fs(fm(x, er), px);
  gy = fs(fm(y, er), py);
}

// The float32 sag and (gx, gy) of a biconic (FIG_BICONIC), toroid or
// freeform row at (x, y, z) (_sag_*_32, _normal_*_32).
template <Flag FL, typename W>
__device__ __forceinline__ void sag_normal_32(W w, float x, float y, float z,
                                              float& fn, float& gx,
                                              float& gy) {
  constexpr int FIG = fig_of(FL), NA = na_of(FL), NO = no_of(FL);
  constexpr int at = W_FIG + A_COEF;
  if constexpr (freeform_fig(FIG)) {
    sag_normal_freeform_32<FL>(w, x, y, z, fn, gx, gy);
    return;
  }
  const float cy = w[W_FIG + A_CY], ky = w[W_FIG + A_KY];
  if constexpr (FIG == FIG_TOROID) {
    const float cr = w[W_FIG + A_CR];
    const float y2 = fm(y, y);
    const float sqv = sqrt0_32(fs(1.f, fm(fm(fm(fa(1.f, ky), cy), cy), y2)));
    float zy = fd(fm(cy, y2), fa(1.f, sqv));
    float dzy = fd(fm(cy, y), max_tiny32(sqv));
    if constexpr (NA > 0) {
      zy = fa(zy, poly_even_32<NA>(y2, w, at));
      dzy = fa(dzy, fm(y, dpoly_even_32<NA>(y2, w, at)));
    }
    if constexpr (NO > 0) {
      zy = fa(zy, poly_odd_32<NO>(y2, w, at + 2 * NA));
      dzy = fa(dzy, fm(y, dpoly_odd_32<NO>(y2, w, at + 2 * NA)));
    }
    const float crp = fd(cr, fs(1.f, fm(cr, zy)));
    const float x2 = fm(x, x);
    const float root = sqrt0_32(fs(1.f, fm(fm(x2, crp), crp)));
    fn = fs(fs(z, zy), fd(fm(crp, x2), fa(1.f, root)));
    const float wr = max_tiny32(root);
    gx = fd(fm(-x, crp), wr);
    gy = fd(-dzy, wr);
  } else {
    const float cx = w[W_FIG + A_CX], kx = w[W_FIG + A_KX];
    const float x2 = fm(x, x), y2 = fm(y, y);
    const float a = fa(fm(cx, x2), fm(cy, y2));
    const float b = fa(fm(fm(fm(fa(1.f, kx), cx), cx), x2),
                       fm(fm(fm(fa(1.f, ky), cy), cy), y2));
    const float s = sqrt0_32(fs(1.f, b));
    const float r2 = fa(x2, y2);
    fn = less_figure_32<NA, NO>(fs(z, fd(a, fa(1.f, s))), r2, w, at);
    const float s_safe = max_tiny32(s);
    const float inv = fd(1.f, fa(1.f, s));
    const float ax = fm(fm(fm(a, fa(1.f, kx)), cx), cx);
    const float ay = fm(fm(fm(a, fa(1.f, ky)), cy), cy);
    gx = fm(fm(-fa(fm(fm(fm(2.f, cx), x), fa(1.f, s)), fd(fm(ax, x), s_safe)),
               inv), inv);
    gy = fm(fm(-fa(fm(fm(fm(2.f, cy), y), fa(1.f, s)), fd(fm(ay, y), s_safe)),
               inv), inv);
    if constexpr (NA > 0) {
      const float d = dpoly_even_32<NA>(r2, w, at);
      gx = fs(gx, fm(x, d));
      gy = fs(gy, fm(y, d));
    }
    if constexpr (NO > 0) {
      const float d = dpoly_odd_32<NO>(r2, w, at + 2 * NA);
      gx = fs(gx, fm(x, d));
      gy = fs(gy, fm(y, d));
    }
  }
}

// -- intercepts ---------------------------------------------------------------

// |res| <= tol (1 + |s|) on the hi words, false for NaN (_residual_ok)
__device__ __forceinline__ df residual_test(df s, df res) {
  if (!(fabsf(res.hi) <= fm(NEWTON_TOL, fa(1.f, fabsf(s.hi))))) {
    const float nan = qnan<float>();
    return {nan, nan};
  }
  return s;
}

// A conic cylinder's closed form in its curved axis w (_intercept_cyl_df).
template <typename W>
__device__ __forceinline__ df intercept_cyl_df(W w, df wv, df z, df uw, df uz,
                                               bool alt, bool fast) {
  const df c = ld(w, W_FIG + A_C1), k1 = ld(w, W_FIG + A_K1);
  const df kz = mul(k1, z);
  const df uy_ = add(mul(uw, wv), mul(uz, kz));
  const df uu = add(sqr(uw), mul(k1, sqr(uz)));
  const df yy = add(sqr(wv), mul(z, kz));
  const df d = sub(mul(c, uy_), uz);
  const df f = sub(mul(c, yy), scale(z, 2.f));
  const df e_q = mul(c, uu);
  const df disc = sub(sqr(d), mul(e_q, f));
  df g = sq(disc, fast);
  const bool ez = e_q.hi == 0.f;
  bool stable;
  if (alt) {
    g = neg(g);
    stable = ez;
  } else {
    stable = d.hi < 0.f || ez;  // false for NaN, as torch.where
  }
  const df num = stable ? f : neg(add(d, g));
  df den = stable ? sub(g, d) : e_q;
  if (den.hi == 0.f) den = {1.f, 0.f};
  return dv(num, den, fast);
}

// A biconic's, toroid's or freeform row's mixed-precision Newton
// (_intercept_anam_df): the float32 y-conic seed (a freeform row's base
// conic; the vertex plane where it misses), float32 steps, df32 rounds,
// the residual test.
template <Flag FL, typename W>
__device__ __forceinline__ df intercept_anam_df(W w, df x, df y, df z, df ux,
                                                df uy, df uz, bool alt,
                                                bool fast) {
  constexpr bool ff = freeform_fig(fig_of(FL));
  float s32 = intercept_conic_32(x.hi, y.hi, z.hi, ux.hi, uy.hi, uz.hi,
                                 ff ? w[W_C] : w[W_FIG + A_CY],
                                 ff ? w[W_FIG + F_KY] : w[W_FIG + A_KY], alt);
  if (isnan(s32)) s32 = fd(-z.hi, uz.hi == 0.f ? 1.f : uz.hi);
#pragma unroll 1
  for (int it = 0; it < ANAM_F32_ITERS; ++it) {
    float fn, gx, gy;
    sag_normal_32<FL>(w, fa(x.hi, fm(s32, ux.hi)), fa(y.hi, fm(s32, uy.hi)),
                      fa(z.hi, fm(s32, uz.hi)), fn, gx, gy);
    float fp = fa(fa(fm(ux.hi, gx), fm(uy.hi, gy)), uz.hi);
    if (fp == 0.f) fp = 1.f;
    s32 = fs(s32, fd(fn, fp));
  }
  df s = {s32, 0.f};
  const int iters = ANAM_DF_ITERS + (fast ? 0 : 1);
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    const df px = add(x, mul(s, ux)), py = add(y, mul(s, uy));
    const df fn = sag_anam_df<FL>(w, px, py, add(z, mul(s, uz)), fast);
    df gx, gy;
    normal_anam_df<FL>(w, px, py, fast, gx, gy);
    df fp = add(add(mul(ux, gx), mul(uy, gy)), uz);
    if (fp.hi == 0.f) fp = {1.f, 0.f};  // NaN stays
    s = sub(s, dv(fn, fp, fast));
  }
  return residual_test(s, sag_anam_df<FL>(
      w, add(x, mul(s, ux)), add(y, mul(s, uy)), add(z, mul(s, uz)), fast));
}

// An aspheric row's df32 Newton from its conic root s (_polish_radial_df):
// no zero-slope guard, as the reference.
template <int NA, int NO, typename W>
__device__ __forceinline__ df polish_radial_df(W w, df x, df y, df z, df ux,
                                               df uy, df uz, df s, df c,
                                               df k1, bool fast) {
#pragma unroll 1
  for (int it = 0; it < DF_ASPHERIC_ITERS; ++it) {
    const df px = add(x, mul(s, ux)), py = add(y, mul(s, uy));
    const df fn = sag_df<NA, NO>(w, px, py, add(z, mul(s, uz)), c, k1, fast);
    const df en = normal_radial_df<NA, NO>(w, px, py, c, k1, fast);
    const df fp = add(add(mul(ux, mul(px, en)), mul(uy, mul(py, en))), uz);
    s = sub(s, dv(fn, fp, fast));
  }
  return residual_test(s, sag_df<NA, NO>(w, add(x, mul(s, ux)),
                                         add(y, mul(s, uy)),
                                         add(z, mul(s, uz)), c, k1, fast));
}

// -- the phase rows (ops/df32._phase_df) -------------------------------------

// sum c_i r2^i by Horner from the last of N pairs at w[at]
// (_poly_horner_df)
template <int N, typename W>
__device__ __forceinline__ df horner_df(W w, int at, df r2) {
  df acc = ld(w, at + 2 * (N - 1));
#pragma unroll
  for (int i = N - 2; i >= 0; --i) acc = add(mul(acc, r2), ld(w, at + 2 * i));
  return acc;
}

// A conic cylinder's normal component in its curved axis: w e, e =
// -c1 / sqrt(1 - (1 + k) c1^2 w^2) (_normal_cyl_df)
template <typename W>
__device__ __forceinline__ df normal_cyl_df(W w, df wv, bool fast) {
  const df one = {1.f, 0.f};
  const df e = neg(dv(ld(w, W_FIG + A_C1),
                      sq(sub(one, mul(ld(w, W_FIG + A_BC), sqr(wv))), fast),
                      fast));
  return mul(wv, e);
}

// The grating/phase solve (_refract_grating_df): b = mu u + T q + s, q
// the y axis projected into the tangent plane of the normal (gx, gy, 1)
// and normalised (PLANE: the y axis), s the DOE's kick (KICK), then u' =
// b + Gamma n; a mirror (KIND 2) takes the root that flips the normal
// component.  An evanescent order is NaN.
template <int KIND, bool PLANE, bool GRAT, bool KICK>
__device__ __forceinline__ void grating_refract_df(df mu, df gdy, df gx,
                                                   df gy, df kx, df ky,
                                                   bool fast, df& ux, df& uy,
                                                   df& uz) {
  const df one = {1.f, 0.f};
  if constexpr (PLANE) {
    df bx = mul(mu, ux);
    df by = GRAT ? add(mul(mu, uy), gdy) : mul(mu, uy);
    if constexpr (KICK) {
      bx = add(bx, kx);
      by = add(by, ky);
    }
    const df bz = mul(mu, uz);
    const df root = sq(sub(sub(one, sqr(bx)), sqr(by)), fast);
    df gam;
    if constexpr (KIND == 2)
      gam = sub(neg(bz), bz.hi >= 0.f ? root : neg(root));
    else
      gam = sub(root, bz);
    ux = bx;
    uy = by;
    uz = add(bz, gam);
  } else {
    const df inv_nn = dv(one, add(add(sqr(gx), sqr(gy)), one), fast);
    df bx = mul(mu, ux), by = mul(mu, uy), bz = mul(mu, uz);
    if constexpr (GRAT) {
      const df qx = neg(mul(mul(gy, gx), inv_nn));
      const df qy = sub(one, mul(sqr(gy), inv_nn));
      const df qz = neg(mul(gy, inv_nn));
      const df qinv = dv(
          one, max_tiny(sq(add(add(sqr(qx), sqr(qy)), sqr(qz)), fast)), fast);
      bx = add(bx, mul(gdy, mul(qx, qinv)));
      by = add(by, mul(gdy, mul(qy, qinv)));
      bz = add(bz, mul(gdy, mul(qz, qinv)));
    }
    if constexpr (KICK) {
      bx = add(bx, kx);
      by = add(by, ky);
    }
    const df bn = mul(add(add(mul(bx, gx), mul(by, gy)), bz), inv_nn);
    const df bb = add(add(sqr(bx), sqr(by)), sqr(bz));
    const df root = sq(sub(sqr(bn), mul(sub(bb, one), inv_nn)), fast);
    df gam;
    if constexpr (KIND == 2)
      gam = sub(neg(bn), bn.hi >= 0.f ? root : neg(root));
    else
      gam = sub(root, bn);
    ux = add(bx, mul(gam, gx));
    uy = add(by, mul(gam, gy));
    uz = add(bz, gam);
  }
}

// -- one step -----------------------------------------------------------------

// One transfer-intercept-refract step (ops/df32._surface_df): state in
// and out in the running frame, s the intercept distance (a DOE row's
// with its phase term).  The step's flags arrive as
// std::integral_constant<Flag, F> (df32_spec.cuh): every `fl & G_*`
// below, the permutation codes, the row kind, the coefficient counts and
// the fast/exact choice are constants and the branches not taken fold
// away.  The Newton rounds stay rolled loops.
template <typename Flags, typename W>
__device__ __forceinline__ void surface_df(W w, Flags flags, df& x, df& y,
                                           df& z, df& ux, df& uy, df& uz,
                                           df& s) {
  constexpr Flag FL = Flags::value;
  constexpr int FIG = fig_of(FL), NA = na_of(FL), NO = no_of(FL);
  constexpr bool fast = FL & G_FAST;
  constexpr bool flat = FL & G_FLAT;
  constexpr bool conic = FL & G_CONIC;
  constexpr bool alt = FL & G_ALTERNATE;
  constexpr bool cyl = FIG == FIG_CYL_Y || FIG == FIG_CYL_X;
  constexpr bool newton =
      FIG == FIG_BICONIC || FIG == FIG_TOROID || freeform_fig(FIG);
  const df one = {1.f, 0.f};
  z = sub(z, ld(w, W_DZ));
  if (FL & G_OFF_AXIS) {
    x = sub(x, ld(w, W_DXY));
    y = sub(y, ld(w, W_DXY + 2));
  }
  frame_apply<false>(w, FL, x, y, z);
  frame_apply<false>(w, FL, ux, uy, uz);
  const df c = ld(w, W_C);
  if constexpr (FIG == FIG_CYL_Y) {
    s = intercept_cyl_df(w, y, z, uy, uz, alt, fast);
  } else if constexpr (FIG == FIG_CYL_X) {
    s = intercept_cyl_df(w, x, z, ux, uz, alt, fast);
  } else if constexpr (newton) {
    s = intercept_anam_df<FL>(w, x, y, z, ux, uy, uz, alt, fast);
  } else if constexpr (flat) {
    s = neg(dv(z, uz, fast));
  } else {
    // closed-form conic intercept; the two root forms -(d+g)/e and
    // f/(g-d) are each stable in the complementary sign regime of d
    df uy_, yy, e_q;
    if constexpr (conic) {
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
    if constexpr (alt) {
      s = dv(neg(sub(d, g)), e_q, fast);
    } else {
      const bool stable = d.hi < 0.f;  // false for NaN, as torch.where
      const df num = stable ? f : neg(add(d, g));
      const df den = stable ? sub(g, d) : e_q;
      s = dv(num, den, fast);
    }
  }
  if constexpr (FIG == FIG_RADIAL)
    s = polish_radial_df<NA, NO>(w, x, y, z, ux, uy, uz, s, c,
                                 conic ? ld(w, W_K1) : one, fast);
  x = add(x, mul(s, ux));
  y = add(y, mul(s, uy));
  z = add(z, mul(s, uz));
  if (FL & G_CLIP) {
    // aperture clip on the hi words: NaN the direction outside
    if (fa(fm(x.hi, x.hi), fm(y.hi, y.hi)) > w[W_RAD]) {
      const float nan = qnan<float>();
      ux = uy = uz = df{nan, nan};
    }
  }
  constexpr int kind = int(FL & G_KIND);
  constexpr bool grating = (FL & G_GRATING) != 0;
  constexpr bool doe = (FL & G_DOE) != 0;
  constexpr int PH = phase_at(FL), ND = nd_of(FL);
  if constexpr (doe) {
    // the DOE's imprinted phase is optical path: psi(r2) n_after /
    // n_before folded into the length, which the caller scales by
    // n_before
    const df r2p = add(sqr(x), sqr(y));
    s = add(s, mul(horner_df<ND>(w, PH + (grating ? 2 : 0) + 2 * ND, r2p),
                   r2p));
  }
  if constexpr (grating || doe) {
    // the substrate's normal (gx, gy, 1): a cylinder's in its curved
    // axis, a biconic's, toroid's or freeform row's, the radial one of a
    // curved or figured row; none on a plane.  Before the passthrough: a
    // grating row in air still diffracts.
    constexpr bool plane = FIG == FIG_NONE && flat;
    const df zero = {0.f, 0.f};
    df gx = zero, gy = zero;
    if constexpr (FIG == FIG_CYL_Y) {
      gy = normal_cyl_df(w, y, fast);
    } else if constexpr (FIG == FIG_CYL_X) {
      gx = normal_cyl_df(w, x, fast);
    } else if constexpr (newton) {
      normal_anam_df<FL>(w, x, y, fast, gx, gy);
    } else if constexpr (!plane) {
      const df e = normal_radial_df<NA, NO>(w, x, y, c,
                                            conic ? ld(w, W_K1) : one, fast);
      gx = mul(x, e);
      gy = mul(y, e);
    }
    df kx = zero, ky = zero;
    if constexpr (doe) {
      const df ek = horner_df<ND>(w, PH + (grating ? 2 : 0),
                                  add(sqr(x), sqr(y)));
      kx = mul(ek, x);
      ky = mul(ek, y);
    }
    grating_refract_df<kind, plane, grating, doe>(
        ld(w, W_MU), grating ? ld(w, PH) : zero, gx, gy, kx, ky, fast, ux,
        uy, uz);
  } else if constexpr (kind != 0) {
    // the normal N = (nx, ny, nzv): a component absent (has_* false) is
    // zero, nzv absent is 1, and unit says |N|^2 == 1 exactly
    df nx, ny, nzv, dot, nn;
    bool has_nx = false, has_ny = false, has_nz = false, unit = true;
    if constexpr (cyl) {
      // a conic cylinder's polynomial normal in its curved axis w:
      // N_w = -c w, N_z = 1 - c(1+k) z, unit on a circular one
      constexpr bool along_y = FIG == FIG_CYL_Y;
      const df nw = neg(mul(ld(w, W_FIG + A_C1), along_y ? y : x));
      nzv = sub(one, mul(ld(w, W_FIG + A_K1C), z));
      has_nz = true;
      dot = add(mul(along_y ? uy : ux, nw), mul(uz, nzv));
      if (FL & G_CYL_CONIC) {
        nn = add(sqr(nw), sqr(nzv));
        unit = false;
      }
      if (along_y) {
        ny = nw;
        has_ny = true;
      } else {
        nx = nw;
        has_nx = true;
      }
    } else if constexpr (FIG == FIG_NONE) {
      if (!flat) {
        // polynomial implicit-gradient normal N = (-c x, -c y,
        // 1 - c(1+k) z); |N| == 1 exactly on a sphere
        nx = neg(mul(c, x));
        ny = neg(mul(c, y));
        nzv = sub(one, mul(conic ? ld(w, W_K1C) : c, z));
        has_nx = has_ny = has_nz = true;
        dot = add(add(mul(ux, nx), mul(uy, ny)), mul(uz, nzv));
        if (conic) {
          nn = add(add(sqr(nx), sqr(ny)), sqr(nzv));
          unit = false;
        }
      } else {
        dot = uz;
      }
    } else {
      // the generic normal (nx, ny, 1) of an aspheric row (a flat one
      // too) or a biconic, toroid or freeform row
      if constexpr (FIG == FIG_RADIAL) {
        const df e = normal_radial_df<NA, NO>(w, x, y, c,
                                              conic ? ld(w, W_K1) : one,
                                              fast);
        nx = mul(x, e);
        ny = mul(y, e);
      } else {
        normal_anam_df<FL>(w, x, y, fast, nx, ny);
      }
      has_nx = has_ny = true;
      unit = false;
      nn = add(add(sqr(nx), sqr(ny)), one);
      dot = add(add(mul(ux, nx), mul(uy, ny)), uz);
    }
    if constexpr (kind == 2) {
      const df a2 = unit ? scale(dot, 2.f) : scale(dv(dot, nn, fast), 2.f);
      if (has_nx) ux = sub(ux, mul(a2, nx));
      if (has_ny) uy = sub(uy, mul(a2, ny));
      uz = has_nz ? sub(uz, mul(a2, nzv)) : sub(uz, a2);
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
      ux = has_nx ? add(mul(mu, ux), mul(g, nx)) : mul(mu, ux);
      uy = has_ny ? add(mul(mu, uy), mul(g, ny)) : mul(mu, uy);
      uz = has_nz ? add(mul(mu, uz), mul(g, nzv)) : add(mul(mu, uz), g);
    }
  }
  frame_apply<true>(w, FL, x, y, z);
  frame_apply<true>(w, FL, ux, uy, uz);
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
