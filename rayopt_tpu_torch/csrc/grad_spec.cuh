// The fused trace (K1), its polychromatic twin (K3), the moment kernels
// -- the spot-moment merit (K2), K3's merit mode, the weighted-moment
// forward (K4) and its polychromatic twin (K6) --, the OPD trace (K8)
// and the adjoints -- K4's analytic adjoint (K5), the polychromatic
// adjoint (K7) and the OPD adjoint (K9) -- for NVIDIA Hopper (sm_90a),
// specialized at compile time on one key: the dtype, the SurfaceSpec
// tuple (one word of trace_common.cuh flags a row), the aperture clip
// and the block size; K3 and K6 also on their wavelength count (K3's
// trace also on the order of its loops); the adjoints also on the
// parameter slots they reduce and on whether they write the ray (and
// weight) cotangents.  The wavelength count of K7 stays a run-time
// argument.  No kernel reads its row flags at run time.
//
// Rows: flat, spherical, conic and even- and odd-aspheric (every
// kernel: an aspheric row's seeded Newton intercept, its radial normal
// and, in K5, K7 and K9, its implicit reverse -- K9's with the path
// cotangent; the key carries the table's coefficient widths,
// RAYOPT_N_ASP and RAYOPT_N_ODD, so the Horner loops have compile-time
// bounds and a row grows by N_ASP + N_ODD words).  Every kernel also
// takes the anamorphic rows (a conic cylinder's closed form, a biconic's
// or toroid's seeded Newton with the figure of the key's widths; K5, K7
// and K9 their reverse by hand, K9's with the path cotangent; the key
// defines RAYOPT_N_ANAM, so that a row grows by curvature_dx and conic_dx
// and the adjoints' slots by their cotangents).  Every kernel takes the
// phase rows too -- a linear grating or a radial diffractive phase on
// any substrate (on a cylinder: its closed-form intercept and the normal
// of the biconic or toroid that made it), by the generalized Spencer &
// Murty solve, a DOE's imprinted phase psi(r2) n_after added to the optical
// path; K5, K7 and K9 their reverse by hand, K9's with the path term's
// cotangent; the key defines RAYOPT_N_GRAT and RAYOPT_N_DOE, so that a
// row grows by grating_dy and by n_after and the DOE coefficients, the
// adjoints' slots by their cotangents (K9's by n_after's too).  K3 and
// K6 stage each table's own phase words; K7 reduces them per table.
// Every kernel takes the freeform XY rows (a conic or aspheric base plus
// a triangular XY-monomial figure: the seeded Newton with the
// vertex-plane restart, the freeform normal; K5, K7 and K9 their reverse
// by hand, with the figure's second derivatives, K9's with the path
// cotangent: a freeform row's optical path is t n_before, as a figured
// row's); the key defines RAYOPT_N_XY, so that a row grows by the XY
// coefficients and the adjoints' slots by their cotangents, last.  K3
// and K6 stage each table's own XY words; K7 reduces them per table.
// Only a freeform figure on an anamorphic base is refused, by every key
// (specialize refuses it).  An adjoint key (K5, K7, K9) asked for the
// rotation (a rot key: RAYOPT_ROT) also reduces each rotated row's nine
// rotation cotangents, R[i][j], after every other slot -- the image
// row's with its second use, the moment frame (K5, K7), or its sphere
// tail's (K9) -- and keeps one more saved state a ray, the state leaving
// the last row its reverse steps through; a key without it compiles as
// before.
//
// Replaces the JAX package's Pallas TPU kernels
//   K1  rayopt_tpu/ops/pallas_trace.py  _trace_kernel         (pallas_trace_final)
//   K2  rayopt_tpu/ops/pallas_trace.py  _merit_kernel         (pallas_trace_merit)
//   K3  rayopt_tpu/ops/pallas_trace.py  _multi_kernel         (pallas_trace_multi)
//   K4  rayopt_tpu/ops/pallas_grad.py  _fwd_kernel            (_moments_impl)
//   K5  rayopt_tpu/ops/pallas_grad.py  _adjoint_kernel        (_moments_bwd)
//   K6  rayopt_tpu/ops/pallas_grad.py  _fwd_kernel_multi      (_moments_multi_impl)
//   K7  rayopt_tpu/ops/pallas_grad.py  _adjoint_kernel_multi  (_moments_multi_bwd)
//   K8  rayopt_tpu/ops/pallas_grad.py  _opd_kernel            (_opd_impl)
//   K9  rayopt_tpu/ops/pallas_grad.py  _opd_adjoint_kernel    (_opd_bwd)
// which the JAX package specializes on the same things (specs, clip,
// diff_fields, and K3's and K6's wavelengths, unrolled at trace time).
// rayopt_tpu_torch.ops.cuda_spec writes a translation unit a key that
// instantiates the templates below with the row words as a template
// parameter pack (Chain<...>) and exports launchers named by the key's
// hash; nvcc builds it at first use.  The plain versions live beside the
// wrappers in rayopt_tpu_torch/ops/cuda_trace.py (K1, K2, K3) and
// rayopt_tpu_torch/ops/cuda_grad.py, with the torch models of K5, K7 and
// K9.
//
// What bounds them on the H100.  K1 reads 6 words a ray and writes 7
// (its final state and optical path); K3 reads 6 and writes 7 a
// wavelength in trace mode, nothing a ray in merit mode; K8 reads 6 and
// writes 3 (k and the landing on the reference sphere); K2 reads 6 words
// a ray and K4 7, and neither writes anything a ray; K6 is K4 once a
// wavelength on one read of the ray; K5 reads 7 and writes 7 a ray when
// asked for the ray cotangents, else nothing; K7 is K5 once a
// wavelength; K9 reads 9 and writes 6 with the ray cotangents, else 3
// and nothing.  All are bound by instruction issue: the chain costs
// ~540 operations a ray on the double Gauss (the adjoints ~4x that: the
// forward, then each row's recompute and reverse), with an IEEE
// division and square roots a row; K1's 52 (float32) or 104 (float64)
// bytes a ray of HBM traffic run beside it.  An aspheric row adds its
// Newton: 11 residuals and 10 slopes, each a square root and a division
// (two in the slope), the Horner loops of its widths, and in the
// adjoints (K5, K7, K9) the whole Newton again in the recompute
// (chip_smoke.row_flops counts them).
//
// What the design does about it.
//  * The row loop unrolls over the parameter pack: surface_step and
//    surface_step_vjp get each row's flags as a std::integral_constant,
//    so every flag branch folds and each row's code is straight-line.
//    The slots a row does not reduce are dead code and compile away.
//  * K1 and K8 read each ray once into registers, run the chain (K8:
//    rows 1..S-2, then the reference-sphere tail of step_vjp.cuh on the
//    image row, its flags compile-time too) and write each output once,
//    coalesced; the table (and K8's aux vector: the sphere centre, its
//    radius and lam_scale, a device tensor, no host sync) sit in static
//    shared memory.  A vignetted ray is NaN and stays NaN through every
//    later row.
//  * K3's trace runs K1's chain, unclipped, once for each table of the
//    key's stack (all of them staged in static shared memory) and writes
//    each wavelength's 7 outputs coalesced.  Two orders, a key each:
//    wavelengths innermost (each ray read once into registers and traced
//    through the tables in turn, the chain unrolled once a table, as the
//    TPU kernel) or outermost (one grid-stride pass over the rays a
//    table: each ray read once a table, the chain compiled once).
//  * The moment kernels (K2, K3's merit, K4, K6) read each ray once into
//    registers and run it through every table of the key's stack in
//    turn (the wavelengths unrolled, each table staged in static shared
//    memory); the five moments of each table accumulate in registers at
//    compile-time indices.  K2 and K3's merit are the unweighted case:
//    no weight stream, a count for the weight.
//  * The adjoints keep the state entering each row in dynamic shared
//    memory, [row][component][thread] (consecutive lanes on consecutive
//    words, no bank conflicts), sized by the table's rows: no per-thread
//    array on the stack, no local-memory traffic.  The staged table and
//    the saved states are read through volatile pointers: unrolled, the
//    rows' words would otherwise be hoisted out of the grid-stride loop
//    and the states forwarded in registers, past the register file.
//  * Each thread accumulates its live slots (or moments) in registers
//    over its grid-stride rays (compile-time indices); the block reduces
//    them across the warp and the block once, and the last block to
//    finish (__threadfence, then an integer atomicAdd on a counter it
//    resets) sums the blocks' partials in block order and writes the
//    result, zeros where a slot is not live.  Deterministic for a given
//    grid; one launch a call, no float atomics.
//  * K7 runs the wavelengths outermost: each block walks its rays for
//    one wavelength's table (staged alone), reduces that wavelength's
//    slots, then the next.  Its accumulators are one wavelength's live
//    slots (as K5's), not nlam times as many, and its shared memory
//    holds one table.  A thread visits the same rays in every pass: it
//    writes its ray and weight cotangents in the first and adds its own
//    earlier value in the later ones, with no atomics.
//  * K9 unrolls rows 1..S-2 with the path cotangent (surface_step_vjp
//    with PATH; on a figured row it joins the ray's cotangent before the
//    Newton's implicit step) and runs the reference-sphere tail
//    (step_vjp.cuh) on the image row with that row's flags compile-time;
//    its three centre cotangents are reduced beside the live slots.
//  * A dead ray (K2/K3/K4/K5/K6/K7: non-finite final x, y or uz, judged
//    per wavelength in K3, K6 and K7; K9: non-finite k) adds no moment
//    and skips its reverse sweep; without ray cotangents nothing is
//    written a ray.
//  * IEEE division and square root, no fast math.
//  * Tensor cores, TMA and wgmma do not apply: each ray's chain is
//    scalar arithmetic whose only products are 3x3 rotations, and a
//    ray is read once a pass, coalesced, as 6 or 7 words.
//
// Interface: plain extern "C" launchers (RAYOPT_SPEC_TRACE,
// RAYOPT_SPEC_TRACE_MULTI, RAYOPT_SPEC_MERIT, RAYOPT_SPEC_MERIT_MULTI,
// RAYOPT_SPEC_MOMENTS, RAYOPT_SPEC_MOMENTS_MULTI, RAYOPT_SPEC_OPD,
// RAYOPT_SPEC_ADJOINT, RAYOPT_SPEC_ADJOINT_MULTI,
// RAYOPT_SPEC_OPD_ADJOINT), loaded with ctypes; each launches on the
// given stream, synchronises nothing, allocates nothing, and returns
// cudaGetLastError() (0 = launched).

#pragma once

#include <type_traits>
#include <utility>

#include "step_vjp.cuh"

namespace {

// a row word's live slots above its flags: cuda_spec.LIVE_SHIFT
constexpr int LIVE_SHIFT = 17;
// the bits above it in a 64-bit word: K5's and K7's FIG_SLOTS, K9's
// OPD_FIG_SLOTS (cuda_spec.LIVE_BITS)
constexpr int LIVE_BITS = 63 - LIVE_SHIFT;
constexpr long long FLAG_MASK = (1LL << LIVE_SHIFT) - 1;
static_assert(FIG_SLOTS <= LIVE_BITS, "too many coefficients a row");

// The rows of one key: W holds a 64-bit word a row, its flags in the
// low LIVE_SHIFT bits and above them the slots (c, k, offset x, y, z,
// mu, then K5's and K7's aspheric coefficients, then an anamorphic
// key's curvature_dx and conic_dx, then a phase key's grating_dy and DOE
// coefficients, then a freeform key's XY coefficients; K9 n_before,
// then its coefficients, the anamorphic two, grating_dy, n_after before
// the DOE coefficients, and the XY coefficients; then a rot key's
// rotation) that row reduces.
template <long long... W>
struct Chain {
  static constexpr int rows = sizeof...(W);
};

template <long long... W>
__host__ __device__ constexpr long long word_at(Chain<W...>, int j) {
  constexpr long long w[] = {W...};
  return w[j];
}

template <class C>
__host__ __device__ constexpr int flags_at(int j) {
  return int(word_at(C{}, j) & FLAG_MASK);
}

template <class C>
__host__ __device__ constexpr long long live_at(int j) {
  return (word_at(C{}, j) >> LIVE_SHIFT) & ((1LL << LIVE_BITS) - 1);
}

__host__ __device__ constexpr int popc_live(long long m) {
  int c = 0;
  for (int q = 0; q < LIVE_BITS; ++q) c += int((m >> q) & 1);
  return c;
}

// index of slot (j, q) among the live slots, rows first; -1 if dead
template <class C>
__host__ __device__ constexpr int slot_index(int j, int q) {
  int b = 0;
  for (int i = 0; i < j; ++i) b += popc_live(live_at<C>(i));
  return (live_at<C>(j) >> q) & 1
             ? b + popc_live(live_at<C>(j) & ((1LL << q) - 1))
             : -1;
}

template <class C>
__host__ __device__ constexpr int live_count() {
  int b = 0;
  for (int i = 0; i < C::rows; ++i) b += popc_live(live_at<C>(i));
  return b;
}

template <class C, int J>
using RowFlags = std::integral_constant<int, flags_at<C>(J)>;

// Sum each of NV per-thread values over the block into s_part[0..NV):
// a warp-shuffle tree, then the warps in order (s_red: BLOCK/32 * NV).
// Every thread of the block must call it.
template <typename T, int BLOCK, int NV>
__device__ __forceinline__ void block_sum(const T (&v)[NV], T* s_red,
                                          T* s_part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    T x = v[q];
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) s_red[warp * NV + q] = x;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < NV; q += BLOCK) {
    T sum = T(0);
    for (int wp = 0; wp < BLOCK / 32; ++wp) sum += s_red[wp * NV + q];
    s_part[q] = sum;
  }
  __syncthreads();
}

// In the last block: s_part[q] = the sum over all blocks b of
// partials[b * ld + q], q < nv, in block order (one warp a value, lane
// b summing blocks b, b + 32, ...).  Every thread of the block must
// call it.
template <typename T, int BLOCK>
__device__ __forceinline__ void sum_blocks(T* s_part, int nv,
                                           const T* __restrict__ partials,
                                           int ld) {
  const int lane = threadIdx.x & 31;
  for (int q = threadIdx.x >> 5; q < nv; q += BLOCK / 32) {
    T v = T(0);
    for (int b = lane; b < int(gridDim.x); b += 32)
      v += __ldcg(partials + int64_t(b) * ld + q);
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) s_part[q] = v;
  }
  __syncthreads();
}

// The grid-wide sum, fused into the launch: each block writes its nv
// partial sums (s_part) to partials[blockIdx.x][.]; the last block to
// finish sums all blocks' partials back into s_part, resets the counter
// and returns true.  Every thread of the block must call it.
template <typename T, int BLOCK>
__device__ __forceinline__ bool grid_sum(T* s_part, int nv,
                                         T* __restrict__ partials,
                                         unsigned int* __restrict__ counter) {
  for (int q = threadIdx.x; q < nv; q += BLOCK)
    partials[int64_t(blockIdx.x) * nv + q] = s_part[q];
  if (!last_block(counter)) return false;
  sum_blocks<T, BLOCK>(s_part, nv, partials, nv);
  if (threadIdx.x == 0) *counter = 0u;
  return true;
}

// The (rows, NQ) parameter cotangents from the reduced live slots
// (s_part), zeros where a slot is not live; the block's threads share
// the words.
template <typename T, class C, int NQ, int BLOCK>
__device__ __forceinline__ void write_slots(T* __restrict__ out,
                                            const T* s_part) {
  static_for(std::make_integer_sequence<int, C::rows * NQ>{}, [&](auto p) {
    constexpr int idx = decltype(p)::value;
    constexpr int k = slot_index<C>(idx / NQ, idx % NQ);
    if (idx % BLOCK == int(threadIdx.x)) {
      if constexpr (k >= 0) {
        out[idx] = s_part[k];
      } else {
        out[idx] = T(0);
      }
    }
  });
}

// Add row J's live slots of pg (NQ columns) into the accumulators.
template <class C, int J, int NQ, typename T, int NA>
__device__ __forceinline__ void add_slots(const T* pg, T (&acc)[NA]) {
  static_for(std::make_integer_sequence<int, NQ>{}, [&](auto c) {
    constexpr int q = decltype(c)::value;
    constexpr int k = slot_index<C>(J, q);
    if constexpr (k >= 0) acc[k] += pg[q];
  });
}

// Add v[0..N) into row J's live slots Q..Q+N of the accumulators (a rot
// key's second use of the image row's rotation).
template <class C, int J, int Q, int N, typename T, int NA>
__device__ __forceinline__ void add_slots_at(const T* v, T (&acc)[NA]) {
  static_for(std::make_integer_sequence<int, N>{}, [&](auto c) {
    constexpr int q = decltype(c)::value;
    constexpr int k = slot_index<C>(J, Q + q);
    if constexpr (k >= 0) acc[k] += v[q];
  });
}

// The forward chain for one ray, its row flags compile-time: row 0's
// frame, then rows 1..R-1; save(j) runs before row j.  Returns
// the optical path.  tab: the staged table, read through a volatile
// pointer so that each row's words are loaded where they are used
// (surface_step).
template <typename T, class C, bool CLIP, int R = C::rows, typename Save>
__device__ __forceinline__ T chain_forward(const volatile T* tab, T* s,
                                           Save&& save) {
  if (flags_at<C>(0) & F_ROTATED) {
    rot_apply_t(tab + P_ROT, s[0], s[1], s[2]);
    rot_apply_t(tab + P_ROT, s[3], s[4], s[5]);
  }
  T tacc = T(0);
  static_for(std::make_integer_sequence<int, R - 1>{}, [&](auto i) {
    constexpr int j = decltype(i)::value + 1;
    save(j);
    surface_step(tab + j * ROW, RowFlags<C, j>{}, CLIP, s[0], s[1], s[2],
                 s[3], s[4], s[5], tacc);
  });
  return tacc;
}

// One ray through one whole table (pallas_trace.py's chain: row 0's
// frame, rows 1..S-1, then the last row's to_normal).  s: in,
// the ray; out, its final state in the last row's frame.  Returns the
// optical path.
template <typename T, class C, bool CLIP>
__device__ __forceinline__ T trace_final_ray(const volatile T* tab, T* s) {
  constexpr int S = C::rows;
  const T t = chain_forward<T, C, CLIP>(tab, s, [](int) {});
  if (flags_at<C>(S - 1) & F_ROTATED) {
    const volatile T* rl = tab + (S - 1) * ROW + P_ROT;
    rot_apply(rl, s[0], s[1], s[2]);
    rot_apply(rl, s[3], s[4], s[5]);
  }
  return t;
}

// The reverse sweep, rows R-1 .. 1: g holds the cotangent of the state
// leaving row R-1 and ends as that of the state entering row 1; each
// row's live slots are added into acc.  saved: this thread's states,
// saved[((j - 1) * 6 + q) * BLOCK] entering row j (a rot key's also the
// state leaving row R-1 at j = R, read as the state leaving a rotated
// row).  With PATH, ct_path is the cotangent of every row's optical path
// (K9).
template <typename T, class C, bool PATH, int R, int BLOCK, int NA>
__device__ __forceinline__ void chain_reverse(const volatile T* tab,
                                             const volatile T* saved, T* g,
                                             T (&acc)[NA],
                                             T ct_path = T(0)) {
  static_for(std::make_integer_sequence<int, R - 1>{}, [&](auto r) {
    constexpr int j = R - 1 - decltype(r)::value;
    T st[6], pg[PG_SLOTS];
#pragma unroll
    for (int q = 0; q < 6; ++q) st[q] = saved[((j - 1) * 6 + q) * BLOCK];
    [[maybe_unused]] T so[6];
    if constexpr (N_ROT > 0 && (flags_at<C>(j) & F_ROTATED) != 0) {
#pragma unroll
      for (int q = 0; q < 6; ++q) so[q] = saved[(j * 6 + q) * BLOCK];
    }
    surface_step_vjp<T, PATH>(tab + j * ROW, RowFlags<C, j>{}, st, g, pg,
                              ct_path, so);
    add_slots<C, j, PATH ? OPD_FIG_SLOTS : FIG_SLOTS>(pg, acc);
  });
}

// One ray of K5 or K7 through one table: (a) the forward recompute,
// keeping the state entering each row (a rot key's with a rotated image
// row also the state leaving it); (b) liveness; (c) the seed from the
// five moment cotangents c (a rot key's also the image row's rotation
// cotangent of the moment frame, its second use of that rotation); (d)
// the reverse sweep, the live slots added into acc.  s: in, the ray.
// g, gw: out, the six state and (with RAYS) the weight cotangents, zeros
// for a dead ray.
template <typename T, class C, bool CLIP, bool RAYS, int BLOCK, int NA>
__device__ __forceinline__ void moments_adjoint_ray(
    const volatile T* tab, volatile T* saved, T* s, const T* __restrict__ w,
    int64_t i, const T (&c)[5], T (&acc)[NA], T* g, T& gw) {
  constexpr int S = C::rows;
  constexpr bool first_rot = flags_at<C>(0) & F_ROTATED;
  constexpr bool last_rot = flags_at<C>(S - 1) & F_ROTATED;
  const volatile T* rl = tab + (S - 1) * ROW + P_ROT;
  chain_forward<T, C, CLIP>(tab, s, [&](int j) {
#pragma unroll
    for (int q = 0; q < 6; ++q) saved[((j - 1) * 6 + q) * BLOCK] = s[q];
  });
  // a rot key: the final position in the global frame
  constexpr bool rot_fin = N_ROT > 0 && last_rot;
  [[maybe_unused]] T sf[3];
  if constexpr (rot_fin) {
#pragma unroll
    for (int q = 0; q < 6; ++q) saved[((S - 1) * 6 + q) * BLOCK] = s[q];
    sf[0] = s[0]; sf[1] = s[1]; sf[2] = s[2];
  }
  if (last_rot) {
    rot_apply(rl, s[0], s[1], s[2]);
    rot_apply(rl, s[3], s[4], s[5]);
  }
  const bool live = isfinite(s[0]) && isfinite(s[1]) && isfinite(s[5]);
#pragma unroll
  for (int q = 0; q < 6; ++q) g[q] = T(0);
  gw = T(0);
  if (!live) return;
  const T xl = s[0], yl = s[1];
  const T wi = w[i];
  g[0] = wi * (c[1] + T(2) * xl * c[3]);
  g[1] = wi * (c[2] + T(2) * yl * c[4]);
  if (RAYS)
    gw = c[0] + xl * c[1] + yl * c[2] + xl * xl * c[3] + yl * yl * c[4];
  if constexpr (rot_fin) {
    // the moment frame (x, y) = (R sf)[0..1] reads the image row's
    // rotation a second time (pallas_grad._adjoint_one's final3)
    T pr[N_ROT];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      pr[q] = g[0] * sf[q];
      pr[3 + q] = g[1] * sf[q];
      pr[6 + q] = T(0);
    }
    add_slots_at<C, S - 1, Q_ROT, N_ROT>(pr, acc);
  }
  if (last_rot) rot_apply_t(rl, g[0], g[1], g[2]);
  chain_reverse<T, C, false, S, BLOCK>(tab, saved, g, acc);
  if (first_rot) {
    rot_apply(tab + P_ROT, g[0], g[1], g[2]);
    rot_apply(tab + P_ROT, g[3], g[4], g[5]);
  }
}

// K2, K3's merit, K4 and K6: each ray read once, traced through each of
// the NLAM tables of a stack (table: NLAM * rows * ROW words, one for K2
// and K4) in turn, then the five moments of each table over the rays
// live there (final x, y and uz finite): with WEIGHTED (K4, K6) sum w,
// sum wx, sum wy, sum wx^2, sum wy^2; without (K2 and K3, no weight
// stream) the count, sum x, sum y, sum x^2, sum y^2.  out: (NLAM, 5).
// All NLAM tables sit in static shared memory.
// MINB: the blocks an SM __launch_bounds__ asks ptxas to fit.  Give it
// (1 at least): with the block size alone ptxas capped the float32 K5
// at 80 registers and spilled; with a minimum of one block it takes 86
// and spills nothing.
template <typename T, class C, bool CLIP, bool WEIGHTED, int NLAM, int BLOCK,
          int MINB>
__global__ void __launch_bounds__(BLOCK, MINB) moments_spec(
    const T* __restrict__ table, const T* __restrict__ ix,
    const T* __restrict__ iy, const T* __restrict__ iz,
    const T* __restrict__ iux, const T* __restrict__ iuy,
    const T* __restrict__ iuz, const T* __restrict__ w,
    T* __restrict__ partials, unsigned int* __restrict__ counter,
    T* __restrict__ out, int64_t n) {
  constexpr int S = C::rows;
  constexpr int NV = 5 * NLAM;
  __shared__ T s_tab[NLAM * S * ROW];
  __shared__ T s_red[BLOCK / 32 * NV];
  __shared__ T s_part[NV];
  for (int i = threadIdx.x; i < NLAM * S * ROW; i += BLOCK)
    s_tab[i] = table[i];
  __syncthreads();
  T m[NV];
#pragma unroll
  for (int q = 0; q < NV; ++q) m[q] = T(0);
  const int64_t stride = int64_t(gridDim.x) * BLOCK;
  for (int64_t i = int64_t(blockIdx.x) * BLOCK + threadIdx.x; i < n;
       i += stride) {
    const T r[6] = {ix[i], iy[i], iz[i], iux[i], iuy[i], iuz[i]};
    // K2 counts its rays: a unit weight, whose products fold away
    T wi = T(1);
    if (WEIGHTED) wi = w[i];
    static_for(std::make_integer_sequence<int, NLAM>{}, [&](auto lc) {
      constexpr int l = decltype(lc)::value;
      const volatile T* tab = s_tab + l * S * ROW;
      T s[6] = {r[0], r[1], r[2], r[3], r[4], r[5]};
      trace_final_ray<T, C, CLIP>(tab, s);
      if (isfinite(s[0]) && isfinite(s[1]) && isfinite(s[5])) {
        m[5 * l] += wi;
        m[5 * l + 1] += wi * s[0];
        m[5 * l + 2] += wi * s[1];
        m[5 * l + 3] += wi * s[0] * s[0];
        m[5 * l + 4] += wi * s[1] * s[1];
      }
    });
  }
  block_sum<T, BLOCK>(m, s_red, s_part);
  if (grid_sum<T, BLOCK>(s_part, NV, partials, counter))
    for (int q = threadIdx.x; q < NV; q += BLOCK) out[q] = s_part[q];
}

// K1: each ray read once and traced through the whole chain
// (trace_final_ray); its final state in the last row's frame and its
// optical path go to the 7 (n,) outputs.  The table sits in static
// shared memory (the key refuses one past 48 KB).
template <typename T, class C, bool CLIP, int BLOCK, int MINB>
__global__ void __launch_bounds__(BLOCK, MINB) trace_spec(
    const T* __restrict__ table, const T* __restrict__ ix,
    const T* __restrict__ iy, const T* __restrict__ iz,
    const T* __restrict__ iux, const T* __restrict__ iuy,
    const T* __restrict__ iuz, T* __restrict__ ox, T* __restrict__ oy,
    T* __restrict__ oz, T* __restrict__ oux, T* __restrict__ ouy,
    T* __restrict__ ouz, T* __restrict__ ot, int64_t n) {
  constexpr int S = C::rows;
  __shared__ T s_tab[S * ROW];
  for (int i = threadIdx.x; i < S * ROW; i += BLOCK) s_tab[i] = table[i];
  __syncthreads();
  const volatile T* tab = s_tab;
  const int64_t stride = int64_t(gridDim.x) * BLOCK;
  for (int64_t i = int64_t(blockIdx.x) * BLOCK + threadIdx.x; i < n;
       i += stride) {
    T s[6] = {ix[i], iy[i], iz[i], iux[i], iuy[i], iuz[i]};
    const T t = trace_final_ray<T, C, CLIP>(tab, s);
    ox[i] = s[0];
    oy[i] = s[1];
    oz[i] = s[2];
    oux[i] = s[3];
    ouy[i] = s[4];
    ouz[i] = s[5];
    ot[i] = t;
  }
}

// K3, trace mode: each ray through each of the NLAM tables of a stack
// (table: NLAM * rows * ROW words, all in static shared memory), with no
// clip (the TPU kernel's); out[(l * 7 + c) * n + i], c = x, y, z, ux, uy,
// uz, t, each written once, coalesced.  OUTER = false: each ray read
// once into registers and traced through the tables in turn, the chain
// unrolled once a table.  OUTER = true: one grid-stride pass over the
// rays a table, each ray read again a table, the chain compiled once
// (the table a run-time offset into shared memory).
template <typename T, class C, bool OUTER, int NLAM, int BLOCK, int MINB>
__global__ void __launch_bounds__(BLOCK, MINB) trace_multi_spec(
    const T* __restrict__ table, const T* __restrict__ ix,
    const T* __restrict__ iy, const T* __restrict__ iz,
    const T* __restrict__ iux, const T* __restrict__ iuy,
    const T* __restrict__ iuz, T* __restrict__ out, int64_t n) {
  constexpr int S = C::rows;
  __shared__ T s_tab[NLAM * S * ROW];
  for (int i = threadIdx.x; i < NLAM * S * ROW; i += BLOCK)
    s_tab[i] = table[i];
  __syncthreads();
  const int64_t stride = int64_t(gridDim.x) * BLOCK;
  const int64_t first = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  // ray i's final state and path through table l
  auto put = [&](const T* s, T t, int l, int64_t i) {
    T* o = out + int64_t(l) * 7 * n + i;
    o[0] = s[0]; o[n] = s[1]; o[2 * n] = s[2];
    o[3 * n] = s[3]; o[4 * n] = s[4]; o[5 * n] = s[5];
    o[6 * n] = t;
  };
  if constexpr (OUTER) {
#pragma unroll 1
    for (int l = 0; l < NLAM; ++l) {
      const volatile T* tab = s_tab + l * S * ROW;
      for (int64_t i = first; i < n; i += stride) {
        T s[6] = {ix[i], iy[i], iz[i], iux[i], iuy[i], iuz[i]};
        const T t = trace_final_ray<T, C, false>(tab, s);
        put(s, t, l, i);
      }
    }
  } else {
    for (int64_t i = first; i < n; i += stride) {
      const T r[6] = {ix[i], iy[i], iz[i], iux[i], iuy[i], iuz[i]};
      static_for(std::make_integer_sequence<int, NLAM>{}, [&](auto lc) {
        constexpr int l = decltype(lc)::value;
        T s[6] = {r[0], r[1], r[2], r[3], r[4], r[5]};
        const T t = trace_final_ray<T, C, false>(s_tab + l * S * ROW, s);
        put(s, t, l, i);
      });
    }
  }
}

// K8: each ray read once, traced through rows 1..S-2 summing the
// optical path, stepped to the image row and onto the reference sphere
// (sphere_tail, the image row's flags compile-time); writes k = -(path
// + ti n_image)/lam_scale and the landing x, y about the sphere's
// centre.  aux: the centre x, y, z, the radius and lam_scale, staged
// beside the table in static shared memory.  A ray that misses the
// sphere is NaN, as a vignetted one.
template <typename T, class C, bool CLIP, int BLOCK, int MINB>
__global__ void __launch_bounds__(BLOCK, MINB) opd_spec(
    const T* __restrict__ table, const T* __restrict__ ix,
    const T* __restrict__ iy, const T* __restrict__ iz,
    const T* __restrict__ iux, const T* __restrict__ iuy,
    const T* __restrict__ iuz, const T* __restrict__ aux,
    T* __restrict__ ok, T* __restrict__ olx, T* __restrict__ oly,
    int64_t n) {
  constexpr int S = C::rows;
  static_assert(S >= 3, "the OPD needs object, exit and image rows");
  __shared__ T s_tab[S * ROW];
  __shared__ T s_aux[AUX];
  for (int i = threadIdx.x; i < S * ROW; i += BLOCK) s_tab[i] = table[i];
  if (threadIdx.x < AUX) s_aux[threadIdx.x] = aux[threadIdx.x];
  __syncthreads();
  const volatile T* tab = s_tab;
  const volatile T* vaux = s_aux;
  const volatile T* pimg = tab + (S - 1) * ROW;
  const int64_t stride = int64_t(gridDim.x) * BLOCK;
  for (int64_t i = int64_t(blockIdx.x) * BLOCK + threadIdx.x; i < n;
       i += stride) {
    T s[6] = {ix[i], iy[i], iz[i], iux[i], iuy[i], iuz[i]};
    const T tacc = chain_forward<T, C, CLIP, S - 1>(tab, s, [](int) {});
    const SphereTail<T> o = sphere_tail(pimg, RowFlags<C, S - 1>{}, vaux, s);
    ok[i] = -(tacc + o.ti * pimg[P_NB]) / vaux[4];
    olx[i] = o.px + o.ti * o.dx;
    oly[i] = o.py + o.ti * o.dy;
  }
}

// K5: the analytic adjoint of K4's moments dotted with ct (5 values).
// out: (rows, FIG_SLOTS) parameter cotangents (SLOTS, then a figured
// table's aspheric coefficients, then an anamorphic key's curvature_dx
// and conic_dx, then a phase key's grating_dy and DOE coefficients, then
// a freeform key's XY coefficients),
// zero where a slot is not live; with
// RAYS the six ray and the weight cotangents a ray (zeros for a dead
// ray).  Dynamic shared memory: the saved states, (rows - 1) * 6 *
// BLOCK words.
template <typename T, class C, bool CLIP, bool RAYS, int BLOCK, int MINB>
__global__ void __launch_bounds__(BLOCK, MINB) merit_adjoint_spec(
    const T* __restrict__ table, const T* __restrict__ ix,
    const T* __restrict__ iy, const T* __restrict__ iz,
    const T* __restrict__ iux, const T* __restrict__ iuy,
    const T* __restrict__ iuz, const T* __restrict__ w,
    const T* __restrict__ ct, T* __restrict__ partials,
    unsigned int* __restrict__ counter, T* __restrict__ out,
    T* __restrict__ ogx, T* __restrict__ ogy, T* __restrict__ ogz,
    T* __restrict__ ogux, T* __restrict__ oguy, T* __restrict__ oguz,
    T* __restrict__ ogw, int64_t n) {
  constexpr int S = C::rows;
  constexpr int NL = live_count<C>();
  constexpr int NA = NL > 0 ? NL : 1;
  __shared__ T s_tab[S * ROW];
  __shared__ T s_red[BLOCK / 32 * NA];
  __shared__ T s_part[NA];
  extern __shared__ __align__(16) unsigned char smem[];
  // the state entering row j, component q of this thread:
  // saved[((j - 1) * 6 + q) * BLOCK]; volatile, so that the compiler
  // keeps the states there instead of forwarding all rows' stores to
  // the reverse sweep's loads in registers
  volatile T* saved = reinterpret_cast<volatile T*>(smem) + threadIdx.x;
  for (int i = threadIdx.x; i < S * ROW; i += BLOCK) s_tab[i] = table[i];
  __syncthreads();
  const T c[5] = {ct[0], ct[1], ct[2], ct[3], ct[4]};
  const volatile T* tab = s_tab;
  T acc[NA];
#pragma unroll
  for (int q = 0; q < NA; ++q) acc[q] = T(0);
  const int64_t stride = int64_t(gridDim.x) * BLOCK;
  for (int64_t i = int64_t(blockIdx.x) * BLOCK + threadIdx.x; i < n;
       i += stride) {
    T s[6] = {ix[i], iy[i], iz[i], iux[i], iuy[i], iuz[i]};
    T g[6], gw;
    moments_adjoint_ray<T, C, CLIP, RAYS, BLOCK>(tab, saved, s, w, i, c, acc,
                                                 g, gw);
    // per-ray cotangents (zeros for a dead ray), when asked
    if (RAYS) {
      ogx[i] = g[0]; ogy[i] = g[1]; ogz[i] = g[2];
      ogux[i] = g[3]; oguy[i] = g[4]; oguz[i] = g[5];
      ogw[i] = gw;
    }
  }
  // the live slots: block, then grid, once
  block_sum<T, BLOCK>(acc, s_red, s_part);
  if (grid_sum<T, BLOCK>(s_part, NL, partials, counter))
    write_slots<T, C, FIG_SLOTS, BLOCK>(out, s_part);
}

// K7: K5 for each table of an nlam stack (table: nlam * rows * ROW
// words), the wavelengths outermost; ct holds nlam rows of the five
// moment cotangents.  out: (nlam, rows, FIG_SLOTS) parameter cotangents
// per wavelength (K5's columns: a phase stack's grating_dy and DOE
// coefficients and a freeform stack's XY coefficients are each table's
// own), zero where a slot is not live;
// with RAYS the six ray and
// the weight cotangents summed over the wavelengths (a ray dead at a
// wavelength adds zeros there).  partials: (grid, nlam, live slots).
// Dynamic shared memory: the saved states, as K5's.
template <typename T, class C, bool CLIP, bool RAYS, int BLOCK, int MINB>
__global__ void __launch_bounds__(BLOCK, MINB) merit_adjoint_multi_spec(
    const T* __restrict__ table, const T* __restrict__ ix,
    const T* __restrict__ iy, const T* __restrict__ iz,
    const T* __restrict__ iux, const T* __restrict__ iuy,
    const T* __restrict__ iuz, const T* __restrict__ w,
    const T* __restrict__ ct, T* __restrict__ partials,
    unsigned int* __restrict__ counter, T* __restrict__ out,
    T* __restrict__ ogx, T* __restrict__ ogy, T* __restrict__ ogz,
    T* __restrict__ ogux, T* __restrict__ oguy, T* __restrict__ oguz,
    T* __restrict__ ogw, int64_t n, int nlam) {
  constexpr int S = C::rows;
  constexpr int NL = live_count<C>();
  constexpr int NA = NL > 0 ? NL : 1;
  __shared__ T s_tab[S * ROW];
  __shared__ T s_red[BLOCK / 32 * NA];
  __shared__ T s_part[NA];
  extern __shared__ __align__(16) unsigned char smem[];
  volatile T* saved = reinterpret_cast<volatile T*>(smem) + threadIdx.x;
  const volatile T* tab = s_tab;
  const int64_t stride = int64_t(gridDim.x) * BLOCK;
  for (int l = 0; l < nlam; ++l) {
    // stage this wavelength's table once the last pass is done with it
    __syncthreads();
    for (int i = threadIdx.x; i < S * ROW; i += BLOCK)
      s_tab[i] = table[l * S * ROW + i];
    __syncthreads();
    const T c[5] = {ct[5 * l], ct[5 * l + 1], ct[5 * l + 2], ct[5 * l + 3],
                    ct[5 * l + 4]};
    T acc[NA];
#pragma unroll
    for (int q = 0; q < NA; ++q) acc[q] = T(0);
    for (int64_t i = int64_t(blockIdx.x) * BLOCK + threadIdx.x; i < n;
         i += stride) {
      T s[6] = {ix[i], iy[i], iz[i], iux[i], iuy[i], iuz[i]};
      T g[6], gw;
      moments_adjoint_ray<T, C, CLIP, RAYS, BLOCK>(tab, saved, s, w, i, c,
                                                   acc, g, gw);
      // the sum over wavelengths, in order: this thread wrote ray i's
      // cotangents in the first pass
      if (RAYS) {
        if (l == 0) {
          ogx[i] = g[0]; ogy[i] = g[1]; ogz[i] = g[2];
          ogux[i] = g[3]; oguy[i] = g[4]; oguz[i] = g[5];
          ogw[i] = gw;
        } else {
          ogx[i] += g[0]; ogy[i] += g[1]; ogz[i] += g[2];
          ogux[i] += g[3]; oguy[i] += g[4]; oguz[i] += g[5];
          ogw[i] += gw;
        }
      }
    }
    // this wavelength's live slots: block, then this block's partials
    block_sum<T, BLOCK>(acc, s_red, s_part);
    for (int q = threadIdx.x; q < NL; q += BLOCK)
      partials[(int64_t(blockIdx.x) * nlam + l) * NL + q] = s_part[q];
  }
  if (!last_block(counter)) return;
  for (int l = 0; l < nlam; ++l) {
    sum_blocks<T, BLOCK>(s_part, NL, partials + l * NL, nlam * NL);
    write_slots<T, C, FIG_SLOTS, BLOCK>(out + int64_t(l) * S * FIG_SLOTS,
                                        s_part);
    __syncthreads();
  }
  if (threadIdx.x == 0) *counter = 0u;
}

// K9: the analytic adjoint of the OPD (K8) for the cotangents (ct_k,
// ct_lx, ct_ly) of its outputs k, lx, ly.  aux: the sphere centre x, y,
// z, its radius and lam_scale.  out: (rows, OPD_FIG_SLOTS) parameter
// cotangents (OPD_SLOTS, then a figured table's aspheric coefficients,
// then an anamorphic key's curvature_dx and conic_dx, then a phase key's
// grating_dy, n_after and DOE coefficients, then a freeform key's XY
// coefficients; zero where a slot is not live), then the 3 centre
// cotangents; with RAYS the six ray cotangents
// a ray (zeros for a dead ray).  Dynamic shared memory: the states entering rows 1..S-2,
// (rows - 2) * 6 * BLOCK words.
template <typename T, class C, bool CLIP, bool RAYS, int BLOCK, int MINB>
__global__ void __launch_bounds__(BLOCK, MINB) opd_adjoint_spec(
    const T* __restrict__ table, const T* __restrict__ ix,
    const T* __restrict__ iy, const T* __restrict__ iz,
    const T* __restrict__ iux, const T* __restrict__ iuy,
    const T* __restrict__ iuz, const T* __restrict__ aux,
    const T* __restrict__ ctk, const T* __restrict__ ctlx,
    const T* __restrict__ ctly, T* __restrict__ partials,
    unsigned int* __restrict__ counter, T* __restrict__ out,
    T* __restrict__ ogx, T* __restrict__ ogy, T* __restrict__ ogz,
    T* __restrict__ ogux, T* __restrict__ oguy, T* __restrict__ oguz,
    int64_t n) {
  constexpr int S = C::rows;
  constexpr int NL = live_count<C>();
  constexpr int NV = NL + 3;        // the live slots, then the centre
  static_assert(OPD_FIG_SLOTS <= LIVE_BITS, "too many coefficients a row");
  using ImgFlags = RowFlags<C, S - 1>;
  __shared__ T s_tab[S * ROW];
  __shared__ T s_aux[AUX];
  __shared__ T s_red[BLOCK / 32 * NV];
  __shared__ T s_part[NV];
  extern __shared__ __align__(16) unsigned char smem[];
  volatile T* saved = reinterpret_cast<volatile T*>(smem) + threadIdx.x;
  for (int i = threadIdx.x; i < S * ROW; i += BLOCK) s_tab[i] = table[i];
  if (threadIdx.x < AUX) s_aux[threadIdx.x] = aux[threadIdx.x];
  __syncthreads();
  const volatile T* tab = s_tab;
  const volatile T* vaux = s_aux;
  const volatile T* pimg = tab + (S - 1) * ROW;
  T acc[NV];
#pragma unroll
  for (int q = 0; q < NV; ++q) acc[q] = T(0);
  const int64_t stride = int64_t(gridDim.x) * BLOCK;
  for (int64_t i = int64_t(blockIdx.x) * BLOCK + threadIdx.x; i < n;
       i += stride) {
    // (a) forward recompute of rows 1..S-2, keeping the state entering
    // each, then the sphere tail
    T s[6] = {ix[i], iy[i], iz[i], iux[i], iuy[i], iuz[i]};
    const T tacc = chain_forward<T, C, CLIP, S - 1>(tab, s, [&](int j) {
#pragma unroll
      for (int q = 0; q < 6; ++q) saved[((j - 1) * 6 + q) * BLOCK] = s[q];
    });
    if constexpr (N_ROT > 0 && (flags_at<C>(S - 2) & F_ROTATED) != 0) {
      // a rot key: the state leaving row S-2, for that row's rotation
#pragma unroll
      for (int q = 0; q < 6; ++q) saved[((S - 2) * 6 + q) * BLOCK] = s[q];
    }
    const SphereTail<T> o = sphere_tail(pimg, ImgFlags{}, vaux, s);
    const T lam_scale = vaux[4];
    const T k = -(tacc + o.ti * pimg[P_NB]) / lam_scale;
    // (b) liveness; (c) the tail's reverse seeds the state cotangent;
    // (d) the reverse sweep, rows S-2 .. 1, with the path cotangent
    T g[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
    if (isfinite(k)) {
      const T ct_path = -ctk[i] / lam_scale;  // reaches every t_j and q
      // the image row's slots: OPD_SLOTS (a rot key's: its rotation too,
      // the last N_ROT of OPD_FIG_SLOTS; the tail writes no other)
      constexpr int TQ = N_ROT > 0 ? OPD_FIG_SLOTS : OPD_SLOTS;
      T pg[TQ], gc[3];
      sphere_tail_vjp(pimg, ImgFlags{}, o, ct_path, ctlx[i], ctly[i], g, pg,
                      gc, s);
      add_slots<C, S - 1, TQ>(pg, acc);
      acc[NL] += gc[0];
      acc[NL + 1] += gc[1];
      acc[NL + 2] += gc[2];
      chain_reverse<T, C, true, S - 1, BLOCK>(tab, saved, g, acc, ct_path);
      if (flags_at<C>(0) & F_ROTATED) {
        rot_apply(tab + P_ROT, g[0], g[1], g[2]);
        rot_apply(tab + P_ROT, g[3], g[4], g[5]);
      }
    }
    // (e) per-ray cotangents (zeros for a dead ray), when asked
    if (RAYS) {
      ogx[i] = g[0]; ogy[i] = g[1]; ogz[i] = g[2];
      ogux[i] = g[3]; oguy[i] = g[4]; oguz[i] = g[5];
    }
  }
  // (f) the live slots and the centre: block, then grid, once
  block_sum<T, BLOCK>(acc, s_red, s_part);
  if (grid_sum<T, BLOCK>(s_part, NV, partials, counter)) {
    write_slots<T, C, OPD_FIG_SLOTS, BLOCK>(out, s_part);
    if (threadIdx.x < 3)
      out[S * OPD_FIG_SLOTS + threadIdx.x] = s_part[NL + threadIdx.x];
  }
}

// The saved states of K5/K7 ((rows - 1) * 6 words a thread) and K9
// ((rows - 2) * 6); a rot key's one row more (cuda_spec.Key.dynamic_smem)
template <typename T, class C, int BLOCK>
constexpr size_t adjoint_dynamic_smem() {
  return size_t(C::rows - 1 + (N_ROT > 0 ? 1 : 0)) * 6 * BLOCK * sizeof(T);
}

template <typename T, class C, int BLOCK>
constexpr size_t opd_dynamic_smem() {
  return size_t(C::rows - 2 + (N_ROT > 0 ? 1 : 0)) * 6 * BLOCK * sizeof(T);
}

}  // namespace
// K1 launchers of one key: NAME(table (rows, ROW), 6 rays, 7 outputs
// (x, y, z, ux, uy, uz, t; (n,) each), n, grid, stream);
// NAME_blocks_per_sm(&blocks); NAME_error_string(err).
#define RAYOPT_SPEC_TRACE(NAME, T, CHAIN, CLIP, BLOCK, MINB)                  \
  extern "C" int NAME##_blocks_per_sm(int* out) {                             \
    return blocks_per_sm(trace_spec<T, CHAIN, CLIP, BLOCK, MINB>, BLOCK, 0,   \
                         out);                                                \
  }                                                                           \
  extern "C" const char* NAME##_error_string(int err) {                       \
    return cudaGetErrorString(cudaError_t(err));                              \
  }                                                                           \
  extern "C" int NAME(const void* table, const void* x, const void* y,        \
                      const void* z, const void* ux, const void* uy,          \
                      const void* uz, void* ox, void* oy, void* oz,           \
                      void* oux, void* ouy, void* ouz, void* ot, long long n, \
                      int grid, void* stream) {                               \
    trace_spec<T, CHAIN, CLIP, BLOCK, MINB>                                   \
        <<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(              \
            static_cast<const T*>(table), static_cast<const T*>(x),           \
            static_cast<const T*>(y), static_cast<const T*>(z),               \
            static_cast<const T*>(ux), static_cast<const T*>(uy),             \
            static_cast<const T*>(uz), static_cast<T*>(ox),                   \
            static_cast<T*>(oy), static_cast<T*>(oz), static_cast<T*>(oux),   \
            static_cast<T*>(ouy), static_cast<T*>(ouz), static_cast<T*>(ot),  \
            int64_t(n));                                                      \
    return int(cudaGetLastError());                                           \
  }

// K3 trace launchers of one key: NAME(table (NLAM, rows, ROW), 6 rays,
// out (NLAM, 7, n), n, grid, stream); NAME_blocks_per_sm(&blocks);
// NAME_error_string(err).
#define RAYOPT_SPEC_TRACE_MULTI(NAME, T, CHAIN, OUTER, NLAM, BLOCK, MINB)     \
  extern "C" int NAME##_blocks_per_sm(int* out) {                             \
    return blocks_per_sm(                                                     \
        trace_multi_spec<T, CHAIN, OUTER, NLAM, BLOCK, MINB>, BLOCK, 0, out); \
  }                                                                           \
  extern "C" const char* NAME##_error_string(int err) {                       \
    return cudaGetErrorString(cudaError_t(err));                              \
  }                                                                           \
  extern "C" int NAME(const void* table, const void* x, const void* y,        \
                      const void* z, const void* ux, const void* uy,          \
                      const void* uz, void* out, long long n, int grid,       \
                      void* stream) {                                         \
    trace_multi_spec<T, CHAIN, OUTER, NLAM, BLOCK, MINB>                      \
        <<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(              \
            static_cast<const T*>(table), static_cast<const T*>(x),           \
            static_cast<const T*>(y), static_cast<const T*>(z),               \
            static_cast<const T*>(ux), static_cast<const T*>(uy),             \
            static_cast<const T*>(uz), static_cast<T*>(out), int64_t(n));     \
    return int(cudaGetLastError());                                           \
  }

// K8 launchers of one key: NAME(table (rows, ROW), 6 rays, aux (AUX,),
// k, lx, ly ((n,) each), n, grid, stream); NAME_blocks_per_sm(&blocks);
// NAME_error_string(err).
#define RAYOPT_SPEC_OPD(NAME, T, CHAIN, CLIP, BLOCK, MINB)                    \
  extern "C" int NAME##_blocks_per_sm(int* out) {                             \
    return blocks_per_sm(opd_spec<T, CHAIN, CLIP, BLOCK, MINB>, BLOCK, 0,     \
                         out);                                                \
  }                                                                           \
  extern "C" const char* NAME##_error_string(int err) {                       \
    return cudaGetErrorString(cudaError_t(err));                              \
  }                                                                           \
  extern "C" int NAME(const void* table, const void* x, const void* y,        \
                      const void* z, const void* ux, const void* uy,          \
                      const void* uz, const void* aux, void* k, void* lx,     \
                      void* ly, long long n, int grid, void* stream) {        \
    opd_spec<T, CHAIN, CLIP, BLOCK, MINB>                                     \
        <<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(              \
            static_cast<const T*>(table), static_cast<const T*>(x),           \
            static_cast<const T*>(y), static_cast<const T*>(z),               \
            static_cast<const T*>(ux), static_cast<const T*>(uy),             \
            static_cast<const T*>(uz), static_cast<const T*>(aux),            \
            static_cast<T*>(k), static_cast<T*>(lx), static_cast<T*>(ly),     \
            int64_t(n));                                                      \
    return int(cudaGetLastError());                                           \
  }

// The launchers of one moment key (K2, K3's merit, K4, K6): NAME(table
// (NLAM, rows, ROW), 6 rays, w (ignored, may be null, without
// WEIGHTED), partials (grid, NLAM * 5), counter (1 zeroed uint32, reset
// by the kernel), out (NLAM, 5), n, grid, stream);
// NAME_blocks_per_sm(&blocks); NAME_error_string(err).
#define RAYOPT_SPEC_MOMENTS_OF(NAME, T, CHAIN, CLIP, WEIGHTED, NLAM, BLOCK,   \
                               MINB)                                          \
  extern "C" int NAME##_blocks_per_sm(int* out) {                             \
    return blocks_per_sm(                                                     \
        moments_spec<T, CHAIN, CLIP, WEIGHTED, NLAM, BLOCK, MINB>, BLOCK, 0,  \
        out);                                                                 \
  }                                                                           \
  extern "C" const char* NAME##_error_string(int err) {                       \
    return cudaGetErrorString(cudaError_t(err));                              \
  }                                                                           \
  extern "C" int NAME(const void* table, const void* x, const void* y,        \
                      const void* z, const void* ux, const void* uy,          \
                      const void* uz, const void* w, void* partials,          \
                      void* counter, void* out, long long n, int grid,        \
                      void* stream) {                                         \
    moments_spec<T, CHAIN, CLIP, WEIGHTED, NLAM, BLOCK, MINB>                 \
        <<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(              \
            static_cast<const T*>(table), static_cast<const T*>(x),           \
            static_cast<const T*>(y), static_cast<const T*>(z),               \
            static_cast<const T*>(ux), static_cast<const T*>(uy),             \
            static_cast<const T*>(uz), static_cast<const T*>(w),              \
            static_cast<T*>(partials), static_cast<unsigned int*>(counter),   \
            static_cast<T*>(out), int64_t(n));                                \
    return int(cudaGetLastError());                                           \
  }

// K2: the five count moments of one table (no weight stream)
#define RAYOPT_SPEC_MERIT(NAME, T, CHAIN, CLIP, BLOCK, MINB)                  \
  RAYOPT_SPEC_MOMENTS_OF(NAME, T, CHAIN, CLIP, false, 1, BLOCK, MINB)

// K3's merit mode: the five count moments of each of NLAM tables
#define RAYOPT_SPEC_MERIT_MULTI(NAME, T, CHAIN, CLIP, NLAM, BLOCK, MINB)      \
  RAYOPT_SPEC_MOMENTS_OF(NAME, T, CHAIN, CLIP, false, NLAM, BLOCK, MINB)

// K4: the five weighted moments of one table
#define RAYOPT_SPEC_MOMENTS(NAME, T, CHAIN, CLIP, BLOCK, MINB)                \
  RAYOPT_SPEC_MOMENTS_OF(NAME, T, CHAIN, CLIP, true, 1, BLOCK, MINB)

// K6: the five weighted moments of each of NLAM tables
#define RAYOPT_SPEC_MOMENTS_MULTI(NAME, T, CHAIN, CLIP, NLAM, BLOCK, MINB)    \
  RAYOPT_SPEC_MOMENTS_OF(NAME, T, CHAIN, CLIP, true, NLAM, BLOCK, MINB)

// K5 launchers of one key: NAME(table, 6 rays, w, ct (5,), partials
// (grid, live slots), counter, out (rows, FIG_SLOTS), 6 ray + 1 weight
// cotangents (n,; ignored without RAYS), n, grid, stream);
// NAME_blocks_per_sm(&blocks); NAME_error_string(err).
#define RAYOPT_SPEC_ADJOINT(NAME, T, CHAIN, CLIP, RAYS, BLOCK, MINB)          \
  extern "C" int NAME##_blocks_per_sm(int* out) {                             \
    return blocks_per_sm(                                                     \
        merit_adjoint_spec<T, CHAIN, CLIP, RAYS, BLOCK, MINB>, BLOCK,         \
        adjoint_dynamic_smem<T, CHAIN, BLOCK>(), out);                        \
  }                                                                           \
  extern "C" const char* NAME##_error_string(int err) {                       \
    return cudaGetErrorString(cudaError_t(err));                              \
  }                                                                           \
  extern "C" int NAME(const void* table, const void* x, const void* y,        \
                      const void* z, const void* ux, const void* uy,          \
                      const void* uz, const void* w, const void* ct,          \
                      void* partials, void* counter, void* out, void* gx,     \
                      void* gy, void* gz, void* gux, void* guy, void* guz,    \
                      void* gw, long long n, int grid, void* stream) {        \
    const size_t smem = adjoint_dynamic_smem<T, CHAIN, BLOCK>();              \
    cudaError_t err = allow_smem(                                             \
        merit_adjoint_spec<T, CHAIN, CLIP, RAYS, BLOCK, MINB>, smem);         \
    if (err != cudaSuccess) return int(err);                                  \
    merit_adjoint_spec<T, CHAIN, CLIP, RAYS, BLOCK, MINB>                     \
        <<<grid, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(           \
            static_cast<const T*>(table), static_cast<const T*>(x),           \
            static_cast<const T*>(y), static_cast<const T*>(z),               \
            static_cast<const T*>(ux), static_cast<const T*>(uy),             \
            static_cast<const T*>(uz), static_cast<const T*>(w),              \
            static_cast<const T*>(ct), static_cast<T*>(partials),             \
            static_cast<unsigned int*>(counter), static_cast<T*>(out),        \
            static_cast<T*>(gx), static_cast<T*>(gy), static_cast<T*>(gz),    \
            static_cast<T*>(gux), static_cast<T*>(guy),                       \
            static_cast<T*>(guz), static_cast<T*>(gw), int64_t(n));           \
    return int(cudaGetLastError());                                           \
  }

// K7 launchers of one key: NAME(table (nlam, rows, ROW), 6 rays, w, ct
// (nlam, 5), partials (grid, nlam, live slots), counter, out (nlam,
// rows, FIG_SLOTS), 6 ray + 1 weight cotangents (n,; ignored without RAYS),
// n, nlam, grid, stream); NAME_blocks_per_sm(&blocks);
// NAME_error_string(err).
#define RAYOPT_SPEC_ADJOINT_MULTI(NAME, T, CHAIN, CLIP, RAYS, BLOCK, MINB)    \
  extern "C" int NAME##_blocks_per_sm(int* out) {                             \
    return blocks_per_sm(                                                     \
        merit_adjoint_multi_spec<T, CHAIN, CLIP, RAYS, BLOCK, MINB>, BLOCK,   \
        adjoint_dynamic_smem<T, CHAIN, BLOCK>(), out);                        \
  }                                                                           \
  extern "C" const char* NAME##_error_string(int err) {                       \
    return cudaGetErrorString(cudaError_t(err));                              \
  }                                                                           \
  extern "C" int NAME(const void* table, const void* x, const void* y,        \
                      const void* z, const void* ux, const void* uy,          \
                      const void* uz, const void* w, const void* ct,          \
                      void* partials, void* counter, void* out, void* gx,     \
                      void* gy, void* gz, void* gux, void* guy, void* guz,    \
                      void* gw, long long n, int nlam, int grid,              \
                      void* stream) {                                         \
    if (nlam < 1) return int(cudaErrorInvalidValue);                          \
    const size_t smem = adjoint_dynamic_smem<T, CHAIN, BLOCK>();              \
    cudaError_t err = allow_smem(                                             \
        merit_adjoint_multi_spec<T, CHAIN, CLIP, RAYS, BLOCK, MINB>, smem);   \
    if (err != cudaSuccess) return int(err);                                  \
    merit_adjoint_multi_spec<T, CHAIN, CLIP, RAYS, BLOCK, MINB>               \
        <<<grid, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(           \
            static_cast<const T*>(table), static_cast<const T*>(x),           \
            static_cast<const T*>(y), static_cast<const T*>(z),               \
            static_cast<const T*>(ux), static_cast<const T*>(uy),             \
            static_cast<const T*>(uz), static_cast<const T*>(w),              \
            static_cast<const T*>(ct), static_cast<T*>(partials),             \
            static_cast<unsigned int*>(counter), static_cast<T*>(out),        \
            static_cast<T*>(gx), static_cast<T*>(gy), static_cast<T*>(gz),    \
            static_cast<T*>(gux), static_cast<T*>(guy),                       \
            static_cast<T*>(guz), static_cast<T*>(gw), int64_t(n), nlam);     \
    return int(cudaGetLastError());                                           \
  }

// K9 launchers of one key: NAME(table (rows, ROW), 6 rays, aux (AUX,),
// ct_k, ct_lx, ct_ly (n,), partials (grid, live slots + 3), counter,
// out (rows * OPD_FIG_SLOTS + 3), 6 ray cotangents (n,; ignored without
// RAYS), n, grid, stream); NAME_blocks_per_sm(&blocks);
// NAME_error_string(err).
#define RAYOPT_SPEC_OPD_ADJOINT(NAME, T, CHAIN, CLIP, RAYS, BLOCK, MINB)      \
  extern "C" int NAME##_blocks_per_sm(int* out) {                             \
    return blocks_per_sm(opd_adjoint_spec<T, CHAIN, CLIP, RAYS, BLOCK, MINB>, \
                         BLOCK, opd_dynamic_smem<T, CHAIN, BLOCK>(), out);    \
  }                                                                           \
  extern "C" const char* NAME##_error_string(int err) {                       \
    return cudaGetErrorString(cudaError_t(err));                              \
  }                                                                           \
  extern "C" int NAME(const void* table, const void* x, const void* y,        \
                      const void* z, const void* ux, const void* uy,          \
                      const void* uz, const void* aux, const void* ctk,       \
                      const void* ctlx, const void* ctly, void* partials,     \
                      void* counter, void* out, void* gx, void* gy, void* gz, \
                      void* gux, void* guy, void* guz, long long n, int grid, \
                      void* stream) {                                         \
    const size_t smem = opd_dynamic_smem<T, CHAIN, BLOCK>();                  \
    cudaError_t err = allow_smem(                                             \
        opd_adjoint_spec<T, CHAIN, CLIP, RAYS, BLOCK, MINB>, smem);           \
    if (err != cudaSuccess) return int(err);                                  \
    opd_adjoint_spec<T, CHAIN, CLIP, RAYS, BLOCK, MINB>                       \
        <<<grid, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(           \
            static_cast<const T*>(table), static_cast<const T*>(x),           \
            static_cast<const T*>(y), static_cast<const T*>(z),               \
            static_cast<const T*>(ux), static_cast<const T*>(uy),             \
            static_cast<const T*>(uz), static_cast<const T*>(aux),            \
            static_cast<const T*>(ctk), static_cast<const T*>(ctlx),          \
            static_cast<const T*>(ctly), static_cast<T*>(partials),           \
            static_cast<unsigned int*>(counter), static_cast<T*>(out),        \
            static_cast<T*>(gx), static_cast<T*>(gy), static_cast<T*>(gz),    \
            static_cast<T*>(gux), static_cast<T*>(guy),                       \
            static_cast<T*>(guz), int64_t(n));                                \
    return int(cudaGetLastError());                                           \
  }
