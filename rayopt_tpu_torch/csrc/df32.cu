// Double-single ("df32") parity-grade trace for NVIDIA Hopper (sm_90a):
// the df32 trace (K10), its polychromatic twin (K11) and the fused df32
// spot-moment merits (K12, K13).
//
// Replaces the JAX package's Pallas TPU kernels
//   K10  rayopt_tpu/ops/df32.py  pallas_trace_df32             (kernel :1094)
//   K11  rayopt_tpu/ops/df32.py  pallas_trace_df32_multi       (kernel :1140)
//   K12  rayopt_tpu/ops/df32.py  pallas_trace_df32_merit       (kernel :1285)
//   K13  rayopt_tpu/ops/df32.py  pallas_trace_df32_merit_multi (kernel :1321)
// and computes, word for word, what rayopt_tpu_torch/ops/df32.py computes
// (the plain versions; the wrappers are in ops/cuda_df32.py).
//
// A df32 number is an (hi, lo) pair of floats carrying ~2^-47 relative
// precision.  Its error-free transforms (two_sum, Dekker's split and
// two_prod) hold only if every float32 add, subtract, multiply, divide
// and square root is rounded exactly as written.  nvcc contracts a
// multiply feeding an add into one fused multiply-add by default, which
// rounds once where the code rounds twice and silently degrades the lo
// words to float32 level.  So every float32 operation here is written
// with a round-to-nearest intrinsic (__fadd_rn, __fsub_rn, __fmul_rn,
// __fdiv_rn, __fsqrt_rn), which the compiler never contracts; that holds
// whatever the build flags, so the source needs no flags of its own.
// Division and square root are correctly rounded, as the plain version's
// (true division; the square-root seed taken in float64 and rounded
// once).  Dekker's split is kept in two_prod (an FMA form would be exact
// too, and faster: later work).
//
// What bounds it on the H100.  One ray through the double Gauss costs
// 9.7k (fast plan) to 11.1k (exact) float32 operations with the path
// (chip_smoke.df32_step_ops) against 48 bytes read and 56 written (K10
// with the path): ~100 operations a byte, five times the ridge of the
// H100 SXM data sheet's 67 TFLOP/s and 3.35 TB/s.  The kernels are bound
// by operations, and none of them may be fused into a multiply-add.
//
// What the design does about it.
//  * One thread per ray, a grid-stride loop; the 12 state words and the
//    2 path words stay in registers through the whole chain, so each ray
//    is read once and (K10/K11) written once.
//  * The plan is packed on the host into DW float words and one int32 of
//    flags a step (kind, flat, conic, alternate, rotation mode and
//    signed permutation, off-axis, clip, fast), staged once per block
//    into shared memory.  Every thread reads the same address (a
//    broadcast) and the flags are uniform across the warp, so branching
//    on them costs no divergence.
//  * K11/K13 stage every wavelength's plan whole, flags included, and
//    trace each ray, read once, through each of them.
//  * K12/K13 reduce deterministically, without atomics: a df32
//    accumulator per thread (K13: a shared-memory column per thread and
//    wavelength), warp shuffles with df32 add, then one warp over the
//    block's warps; one (hi, lo) pair per moment per block, which the
//    wrapper promotes to float64 and sums.
//
// Interface: plain extern "C" launchers, loaded with ctypes; each
// launches on the given stream, synchronises nothing, allocates nothing,
// and returns cudaGetLastError() (0 = launched).

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

__device__ __forceinline__ df split(float a) {
  const float t = fm(4097.f, a);  // 2^12 + 1
  const float hi = fs(t, fs(t, a));
  return {hi, fs(a, hi)};
}

__device__ __forceinline__ df two_prod(float a, float b) {
  const float p = fm(a, b);
  const df as = split(a);
  const df bs = split(b);
  // ((ah*bh - p) + ah*bl + al*bh) + al*bl
  const float e = fa(fa(fa(fs(fm(as.hi, bs.hi), p), fm(as.hi, bs.lo)),
                        fm(as.lo, bs.hi)),
                     fm(as.lo, bs.lo));
  return {p, e};
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

__device__ __forceinline__ df ld(const float* w, int i) {
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
template <bool T>
__device__ __forceinline__ void rot_apply(const float* w, df& x, df& y,
                                          df& z) {
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

// -- one step and the chain ---------------------------------------------------

// One transfer-intercept-refract step (ops/df32._surface_df): state in
// and out in the running frame, s the intercept distance.
__device__ __forceinline__ void surface_df(const float* w, int fl, df& x,
                                           df& y, df& z, df& ux, df& uy,
                                           df& uz, df& s) {
  const bool fast = fl & G_FAST;
  const bool flat = fl & G_FLAT;
  const bool conic = fl & G_CONIC;
  const df one = {1.f, 0.f};
  z = sub(z, ld(w, W_DZ));
  if (fl & G_OFF_AXIS) {
    x = sub(x, ld(w, W_DXY));
    y = sub(y, ld(w, W_DXY + 2));
  }
  if (fl & G_PERM) {
    perm_apply(fl, x, y, z);
    perm_apply(fl, ux, uy, uz);
  } else if (fl & G_ROT) {
    rot_apply<false>(w, x, y, z);
    rot_apply<false>(w, ux, uy, uz);
  }
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
  if (fl & G_PERM) {
    perm_apply_t(fl, x, y, z);
    perm_apply_t(fl, ux, uy, uz);
  } else if (fl & G_ROT) {
    rot_apply<true>(w, x, y, z);
    rot_apply<true>(w, ux, uy, uz);
  }
}

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

// The whole planned chain for one ray (ops/df32.trace_df32_final), then
// the last step's frame (_to_last_frame); PATH sums s * n_before.
template <bool PATH>
__device__ __forceinline__ void trace_df(const float* words, const int* flags,
                                         int nsteps, Rays& r, df& tacc) {
  tacc = {0.f, 0.f};
  for (int j = 0; j < nsteps; ++j) {
    const float* w = words + j * DW;
    df s;
    surface_df(w, flags[j], r.x, r.y, r.z, r.ux, r.uy, r.uz, s);
    if (PATH) tacc = add(tacc, mul(s, ld(w, W_NB)));
  }
  const int fl = flags[nsteps - 1];
  if (fl & G_PERM) {
    perm_apply(fl, r.x, r.y, r.z);
    perm_apply(fl, r.ux, r.uy, r.uz);
  } else if (fl & G_ROT) {
    const float* w = words + (nsteps - 1) * DW;
    rot_apply<false>(w, r.x, r.y, r.z);
    rot_apply<false>(w, r.ux, r.uy, r.uz);
  }
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

// Stage nplans plans of nsteps steps (words and flags) into shared
// memory; returns the first free float after them.
__device__ __forceinline__ float* stage_plans(const float* words,
                                              const int* flags, int nsteps,
                                              int nplans, float* s_words,
                                              int* s_flags) {
  for (int i = threadIdx.x; i < nplans * nsteps * DW; i += blockDim.x)
    s_words[i] = words[i];
  for (int i = threadIdx.x; i < nplans * nsteps; i += blockDim.x)
    s_flags[i] = flags[i];
  __syncthreads();
  return s_words + nplans * nsteps * DW;
}

// -- the kernels --------------------------------------------------------------

// K10: out[(2k + h) * n + i], k = x, y, z, ux, uy, uz (and t with PATH),
// h = hi, lo.  Shared: words, then flags.
template <bool PATH>
__global__ void df32_trace_kernel(const float* __restrict__ words,
                                  const int* __restrict__ flags, int nsteps,
                                  In12 in, float* __restrict__ out,
                                  int64_t n) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_words = reinterpret_cast<float*>(smem);
  int* s_flags = reinterpret_cast<int*>(s_words + nsteps * DW);
  stage_plans(words, flags, nsteps, 1, s_words, s_flags);
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    Rays r = load_rays(in, i);
    df tacc;
    trace_df<PATH>(s_words, s_flags, nsteps, r, tacc);
    store_rays(out, n, i, r, PATH ? &tacc : nullptr);
  }
}

// K11: each ray, read once, through each of nplans plans;
// out[((l * per) + 2k + h) * n + i], per = 14 with PATH, else 12.
template <bool PATH>
__global__ void df32_trace_multi_kernel(const float* __restrict__ words,
                                        const int* __restrict__ flags,
                                        int nsteps, int nplans, In12 in,
                                        float* __restrict__ out, int64_t n) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_words = reinterpret_cast<float*>(smem);
  int* s_flags = reinterpret_cast<int*>(s_words + nplans * nsteps * DW);
  stage_plans(words, flags, nsteps, nplans, s_words, s_flags);
  const int per = PATH ? 14 : 12;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const Rays r0 = load_rays(in, i);
    for (int l = 0; l < nplans; ++l) {
      Rays r = r0;
      df tacc;
      trace_df<PATH>(s_words + l * nsteps * DW, s_flags + l * nsteps, nsteps,
                     r, tacc);
      store_rays(out + int64_t(l) * per * n, n, i, r,
                 PATH ? &tacc : nullptr);
    }
  }
}

// K12: partials[blockIdx.x * 10 + 2q + h], q = count, sum x, sum y,
// sum x^2, sum y^2.  Shared: words, scratch (10 a warp), flags.
__global__ void df32_merit_kernel(const float* __restrict__ words,
                                  const int* __restrict__ flags, int nsteps,
                                  In12 in, float* __restrict__ partials,
                                  int64_t n) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_words = reinterpret_cast<float*>(smem);
  float* scratch = s_words + nsteps * DW;
  int* s_flags = reinterpret_cast<int*>(scratch + 10 * (blockDim.x >> 5));
  stage_plans(words, flags, nsteps, 1, s_words, s_flags);
  df m[5];
#pragma unroll
  for (int q = 0; q < 5; ++q) m[q] = {0.f, 0.f};
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    Rays r = load_rays(in, i);
    df tacc;
    trace_df<false>(s_words, s_flags, nsteps, r, tacc);
    if (live(r)) accumulate(m, 1, r);
  }
  block_sum_df(m, scratch, partials + int64_t(blockIdx.x) * 10);
}

// K13: K12 for each of nplans plans; each thread keeps its moments in
// its own shared-memory column, acc[(l * 5 + q) * blockDim.x + t];
// partials[(blockIdx.x * nplans + l) * 10 + 2q + h].  Shared: words,
// scratch, acc, flags.
__global__ void df32_merit_multi_kernel(const float* __restrict__ words,
                                        const int* __restrict__ flags,
                                        int nsteps, int nplans, In12 in,
                                        float* __restrict__ partials,
                                        int64_t n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = blockDim.x;
  float* s_words = reinterpret_cast<float*>(smem);
  float* scratch = s_words + nplans * nsteps * DW;
  df* acc = reinterpret_cast<df*>(scratch + 10 * (nb >> 5));
  int* s_flags = reinterpret_cast<int*>(acc + 5 * nplans * nb);
  for (int k = 0; k < 5 * nplans; ++k) acc[k * nb + threadIdx.x] = {0.f, 0.f};
  stage_plans(words, flags, nsteps, nplans, s_words, s_flags);
  const int64_t stride = int64_t(gridDim.x) * nb;
  for (int64_t i = int64_t(blockIdx.x) * nb + threadIdx.x; i < n;
       i += stride) {
    const Rays r0 = load_rays(in, i);
    for (int l = 0; l < nplans; ++l) {
      Rays r = r0;
      df tacc;
      trace_df<false>(s_words + l * nsteps * DW, s_flags + l * nsteps, nsteps,
                      r, tacc);
      if (live(r)) accumulate(acc + 5 * l * nb + threadIdx.x, nb, r);
    }
  }
  for (int l = 0; l < nplans; ++l) {
    df m[5];
#pragma unroll
    for (int q = 0; q < 5; ++q) m[q] = acc[(5 * l + q) * nb + threadIdx.x];
    block_sum_df(m, scratch,
                 partials + (int64_t(blockIdx.x) * nplans + l) * 10);
  }
}

size_t trace_smem(int nsteps, int nplans) {
  return size_t(nplans) * nsteps * (DW * sizeof(float) + sizeof(int));
}

size_t merit_smem(int nsteps, int nplans, int block, bool multi) {
  return trace_smem(nsteps, nplans) + 10 * sizeof(float) * (block / 32) +
         (multi ? 5 * sizeof(df) * size_t(nplans) * block : 0);
}

bool bad_block(int block) {
  return block <= 0 || block > 1024 || block % 32;
}

In12 pack_in(const void* const* p) {
  In12 in;
  for (int k = 0; k < 12; ++k) in.p[k] = static_cast<const float*>(p[k]);
  return in;
}

}  // namespace

#define IN12_PARAMS                                                           \
  const void *xh, const void *xl, const void *yh, const void *yl,            \
      const void *zh, const void *zl, const void *uxh, const void *uxl,      \
      const void *uyh, const void *uyl, const void *uzh, const void *uzl
#define IN12_ARRAY {xh, xl, yh, yl, zh, zl, uxh, uxl, uyh, uyl, uzh, uzl}

// K10: words (nsteps, DW) float32, flags (nsteps,) int32, the 12 input
// words, out (12 or 14 with_path, n) float32.
extern "C" int df32_trace_final(const void* words, const void* flags,
                                int nsteps, int with_path, IN12_PARAMS,
                                void* out, long long n, int grid, int block,
                                void* stream) {
  if (bad_block(block) || nsteps < 1) return int(cudaErrorInvalidValue);
  const void* p[12] = IN12_ARRAY;
  const size_t smem = trace_smem(nsteps, 1);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const float*>(words);
  const auto* f = static_cast<const int*>(flags);
  auto* o = static_cast<float*>(out);
  if (with_path) {
    cudaError_t err = allow_smem(df32_trace_kernel<true>, smem);
    if (err != cudaSuccess) return int(err);
    df32_trace_kernel<true><<<grid, block, smem, s>>>(w, f, nsteps,
                                                      pack_in(p), o, n);
  } else {
    cudaError_t err = allow_smem(df32_trace_kernel<false>, smem);
    if (err != cudaSuccess) return int(err);
    df32_trace_kernel<false><<<grid, block, smem, s>>>(w, f, nsteps,
                                                       pack_in(p), o, n);
  }
  return int(cudaGetLastError());
}

// K11: words (nplans, nsteps, DW), flags (nplans, nsteps), out
// (nplans, 12 or 14, n).
extern "C" int df32_trace_multi(const void* words, const void* flags,
                                int nsteps, int nplans, int with_path,
                                IN12_PARAMS, void* out, long long n, int grid,
                                int block, void* stream) {
  if (bad_block(block) || nsteps < 1 || nplans < 1)
    return int(cudaErrorInvalidValue);
  const void* p[12] = IN12_ARRAY;
  const size_t smem = trace_smem(nsteps, nplans);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const float*>(words);
  const auto* f = static_cast<const int*>(flags);
  auto* o = static_cast<float*>(out);
  if (with_path) {
    cudaError_t err = allow_smem(df32_trace_multi_kernel<true>, smem);
    if (err != cudaSuccess) return int(err);
    df32_trace_multi_kernel<true><<<grid, block, smem, s>>>(
        w, f, nsteps, nplans, pack_in(p), o, n);
  } else {
    cudaError_t err = allow_smem(df32_trace_multi_kernel<false>, smem);
    if (err != cudaSuccess) return int(err);
    df32_trace_multi_kernel<false><<<grid, block, smem, s>>>(
        w, f, nsteps, nplans, pack_in(p), o, n);
  }
  return int(cudaGetLastError());
}

// K12: partials (grid, 5, 2) float32.
extern "C" int df32_merit(const void* words, const void* flags, int nsteps,
                          IN12_PARAMS, void* partials, long long n, int grid,
                          int block, void* stream) {
  if (bad_block(block) || nsteps < 1) return int(cudaErrorInvalidValue);
  const void* p[12] = IN12_ARRAY;
  const size_t smem = merit_smem(nsteps, 1, block, false);
  cudaError_t err = allow_smem(df32_merit_kernel, smem);
  if (err != cudaSuccess) return int(err);
  df32_merit_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(words), static_cast<const int*>(flags), nsteps,
      pack_in(p), static_cast<float*>(partials), n);
  return int(cudaGetLastError());
}

// K13: partials (grid, nplans, 5, 2) float32.
extern "C" int df32_merit_multi(const void* words, const void* flags,
                                int nsteps, int nplans, IN12_PARAMS,
                                void* partials, long long n, int grid,
                                int block, void* stream) {
  if (bad_block(block) || nsteps < 1 || nplans < 1)
    return int(cudaErrorInvalidValue);
  const void* p[12] = IN12_ARRAY;
  const size_t smem = merit_smem(nsteps, nplans, block, true);
  cudaError_t err = allow_smem(df32_merit_multi_kernel, smem);
  if (err != cudaSuccess) return int(err);
  df32_merit_multi_kernel<<<grid, block, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(words), static_cast<const int*>(flags), nsteps,
      nplans, pack_in(p), static_cast<float*>(partials), n);
  return int(cudaGetLastError());
}
