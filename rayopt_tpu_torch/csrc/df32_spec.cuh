// The df32 ("double-single") parity-grade trace and spot-moment merit
// for NVIDIA Hopper (sm_90a), compiled per plan key: the trace K10 (one
// plan) and K11 (one plan a wavelength), the merit K12 (one plan) and
// K13.  A key is the distinct flag tuples of its plans (one 64-bit flag
// word a step: kind, flat, conic, alternate, off-axis, the
// signed-permutation codes, rotation, clip and fast, a Newton row's kind
// -- aspheric, conic cylinder in y or x, biconic, toroid, freeform --
// with its even and odd coefficient counts and a freeform row's XY term
// mask (or a dense row's degree), and a phase row's grating and DOE bits
// with the DOE's coefficient count, cuda_df32._step_words), which tuple each
// plan takes, the optical path (K10/K11), where the chain reads the plan
// words, the block size and the launch bound.  The plan words themselves
// (curvature, mu, offsets, rotation, coefficients, grating term, ...)
// stay run-time data: one build serves every wavelength of a table and
// every change of value that keeps the flags.  A step's words follow from
// its flags (step_words): DW, then its figure's, then its phase words.
//
// Replaces the JAX package's Pallas TPU kernels
//   K10  rayopt_tpu/ops/df32.py  pallas_trace_df32             (kernel :1094)
//   K11  rayopt_tpu/ops/df32.py  pallas_trace_df32_multi       (kernel :1140)
//   K12  rayopt_tpu/ops/df32.py  pallas_trace_df32_merit       (kernel :1285)
//   K13  rayopt_tpu/ops/df32.py  pallas_trace_df32_merit_multi (kernel :1321)
// which the JAX package specializes the same way (each plan's steps are
// Python dicts, unrolled at trace time), and computes, word for word,
// what rayopt_tpu_torch/ops/df32.py computes (the plain versions; the
// wrappers are in ops/cuda_df32.py).  rayopt_tpu_torch.ops.cuda_spec
// writes a translation unit a key (Plans<Plan<flag words...>...>,
// PlanMap<tuple of each plan...>) and nvcc builds it at first use.
//
// What bounds them on the H100.  One ray through one double Gauss plan
// costs 5,390 (fast) to 6,392 (exact) float32 operations in this form,
// 5,642 to 6,644 with the path (chip_smoke.df32_chain_ops, an FMA
// counted twice), against 48 bytes read and 56 written a plan (K10/K11
// with the path): bound by operations, and by the issue of unfused
// float32 instructions, one a warp a clock.  The Newton rows cost more:
// the aspheric double Gauss's plan (an even asphere polished in 8 df32
// rounds, the generic normal) 10,675 to 13,257 operations, a biconic row
// 2,535 to 3,986 and a toroid row 2,970 to 5,684 (its float32 seed, 6
// float32 steps and 2-3 df32 rounds) against a spherical row's 591 to
// 691, and the seeded Schmidt plate's freeform row (14 XY terms, each
// round's sag and normal over them) 5,163 to 7,175.  Their rounds are
// rolled loops (#pragma unroll 1), so a Newton row adds one round's
// code, not eight; a freeform row's terms are a compile-time list from
// its flag word, so a term it does not hold costs nothing.
//
// What the design does about it.
//  * two_prod takes its FMA form (df32_common.cuh): mul costs 9 float32
//    operations where Dekker's split costs 24, sqr 8 where it costs 23,
//    with the same words.  The cross terms and the renormalisation stay
//    unfused, as the plain version rounds them.
//  * Every step's flags are a std::integral_constant (surface_df reads
//    them with flag_value): the flag tests, the permutation picks and
//    the fast/exact choice fold at compile time and the step chain
//    unrolls into straight-line code, with no integer, branch or select
//    instruction taking an issue slot from the float32 chain.
//  * Wavelengths outermost: for each plan, a grid-stride loop over the
//    rays loads a ray's 12 words, traces it, and stores it (K10/K11) or
//    adds its moments (K12/K13).  The plan index is a run-time loop over
//    one instantiated chain a flag tuple (a table's wavelengths share
//    one; only mu and n_before differ), so the code is one chain long,
//    not one a plan.  Re-reading the ray each plan costs 48 bytes a ray
//    and plan beside ~5k operations, and no register holds the input ray
//    across the plans.
//  * The plan words travel in the kernel's parameters (a
//    __grid_constant__ struct the launcher fills from the host-side
//    packed words: no upload a call, no device copy).  Read straight
//    from there (WORDS_DIRECT), ptxas keeps most of them in registers
//    across the ray loop: fewer load instructions in the chain, and K11
//    runs fastest so (106 registers, 2 blocks of 256 an SM).  K13's
//    moments and reduction push that to 141 registers, one block an SM;
//    with WORDS_STAGED each block copies the words once into static
//    shared memory and the chain reads that copy through a volatile
//    pointer, where each word is used (56 registers, 2 blocks of 512),
//    K13's faster form.  Every thread reads the same word: a broadcast.
//    At one plan (K10, K12) the words are a third as many and the direct
//    form is the faster for both (64 and 72 registers, 512 threads).
//    One plan too long for the parameters (WORDS_DEVICE, ~226 double
//    Gauss steps and more) is uploaded by the wrapper to a device
//    tensor, which each block stages into dynamic shared memory (opted
//    in above 48 KB) and reads as WORDS_STAGED does; its flags stay
//    compile-time.
//  * K12/K13 keep each plan's five df32 moments in registers, reduce the
//    block with block_sum_df (warp shuffles, df32 adds) into its
//    (hi, lo) pairs, and the last block to finish (last_block) promotes
//    every block's pair exactly to float64 and sums them in block order:
//    one launch a call, no float atomics.
//  * IEEE division and square root, no fast math.
//
// Interface: plain extern "C" launchers (RAYOPT_DF32_TRACE,
// RAYOPT_DF32_MERIT), loaded with ctypes; each launches on the given
// stream, synchronises nothing, allocates nothing, and returns
// cudaGetLastError() (0 = launched).

#pragma once

#include <cstring>
#include <tuple>
#include <type_traits>
#include <utility>

#include "df32_common.cuh"

namespace {

// One flag tuple: a step's 64-bit flag word a step.
template <Flag... F>
struct Plan {
  static constexpr int steps = sizeof...(F);
};

template <Flag... F>
__host__ __device__ constexpr Flag step_flags(Plan<F...>, int j) {
  constexpr Flag f[] = {F...};
  return f[j];
}

template <class P, int J>
using StepFlags = std::integral_constant<Flag, step_flags(P{}, J)>;

// The first word of step j: the words of the steps before it, which
// follow from their flags (step_words).
template <Flag... F>
__host__ __device__ constexpr int step_offset(Plan<F...>, int j) {
  constexpr Flag f[] = {F...};
  int off = 0;
  for (int i = 0; i < j; ++i) off += step_words(f[i]);
  return off;
}

// The words of the longest plan of the tuples P.
template <class... P>
__host__ __device__ constexpr int most_words() {
  int most = 0;
  ((most = step_offset(P{}, P::steps) > most ? step_offset(P{}, P::steps)
                                             : most),
   ...);
  return most;
}

// The key's distinct flag tuples (one step count); `words`, the words of
// its longest plan, is the stride from one plan's words to the next.
template <class... P>
struct Plans {
  static constexpr int count = sizeof...(P);
  template <int I>
  using at = std::tuple_element_t<I, std::tuple<P...>>;
  static constexpr int steps = at<0>::steps;
  static constexpr int words = most_words<P...>();
};

// The tuple each plan takes, plan by plan.
template <int... T>
struct PlanMap {
  static constexpr int nlam = sizeof...(T);
};

// the tuple of plan l, l known at run time: compares and selects, no
// table in memory
template <int... T>
__host__ __device__ constexpr int tuple_of(PlanMap<T...>, int l) {
  int k = 0, out = -1;
  ((out = k++ == l ? T : out), ...);
  return out;
}

// The plan words of a key: nlam * Ps::words floats, plan after plan (a
// plan shorter than the longest padded with zeros).
template <class Ps, class Map>
__host__ __device__ constexpr int plan_words() {
  return Map::nlam * Ps::words;
}

// Where the chain reads the plan words: straight from the kernel's
// parameters, from a copy of them in static shared memory, or from a
// copy in dynamic shared memory of a device tensor (cuda_spec.WORDS_AT).
enum WordsAt : int { WORDS_DIRECT = 0, WORDS_STAGED = 1, WORDS_DEVICE = 2 };

// The kernel parameter that carries the plan words, or (WORDS_DEVICE)
// their device pointer.
template <class Ps, class Map, int AT>
struct KernelWords {
  float w[plan_words<Ps, Map>()];
};

template <class Ps, class Map>
struct KernelWords<Ps, Map, WORDS_DEVICE> {
  const float* w;
};

// The dynamic shared memory of a launch: the device words' copy.
template <class Ps, class Map, int AT>
__host__ constexpr size_t words_smem() {
  return AT == WORDS_DEVICE ? plan_words<Ps, Map>() * sizeof(float) : 0;
}

// One ray through one plan of tuple P (trace_df32_final): the unrolled
// steps, then the last step's frame; PATH sums s * n_before.
template <class P, bool PATH, typename W>
__device__ __forceinline__ void trace_plan(W words, Rays& r, df& tacc) {
  tacc = {0.f, 0.f};
  static_for(std::make_integer_sequence<int, P::steps>{}, [&](auto jc) {
    constexpr int j = decltype(jc)::value;
    constexpr int at = step_offset(P{}, j);
    const W w = words + at;
    df s;
    surface_df(w, StepFlags<P, j>{}, r.x, r.y, r.z, r.ux, r.uy, r.uz, s);
    if (PATH) tacc = add(tacc, mul(s, ld(w, W_NB)));
  });
  constexpr Flag last = step_flags(P{}, P::steps - 1);
  constexpr int at = step_offset(P{}, P::steps - 1);
  const W w = words + at;
  frame_apply<false>(w, last, r.x, r.y, r.z);
  frame_apply<false>(w, last, r.ux, r.uy, r.uz);
}

// f(t, l, plan l's words) for each tuple t (a std::integral_constant)
// and each plan l that takes it, in plan order: a run-time loop over the
// plans, so the chain f instantiates is compiled once a tuple.
template <class Ps, class Map, typename W, typename F>
__device__ __forceinline__ void for_plans(W words, F&& f) {
  static_for(std::make_integer_sequence<int, Ps::count>{}, [&](auto tc) {
    constexpr int t = decltype(tc)::value;
#pragma unroll 1
    for (int l = 0; l < Map::nlam; ++l)
      if (tuple_of(Map{}, l) == t)
        f(tc, l, static_cast<W>(words + l * Ps::words));
  });
}

// The trace: out[((l * per) + 2k + h) * n + i], per = 14 with PATH, else 12;
// k = x, y, z, ux, uy, uz (and t with PATH), h = hi, lo.
template <class Ps, class Map, bool PATH, int BLOCK, typename W>
__device__ __forceinline__ void trace_multi(W words, const In12& in,
                                            float* __restrict__ out,
                                            int64_t n) {
  constexpr int per = PATH ? 14 : 12;
  const int64_t stride = int64_t(gridDim.x) * BLOCK;
  for_plans<Ps, Map>(words, [&](auto tc, int l, W w) {
    using P = typename Ps::template at<decltype(tc)::value>;
    float* o = out + int64_t(l) * per * n;
    for (int64_t i = int64_t(blockIdx.x) * BLOCK + threadIdx.x; i < n;
         i += stride) {
      Rays r = load_rays(in, i);
      df tacc;
      trace_plan<P, PATH>(w, r, tacc);
      store_rays(o, n, i, r, PATH ? &tacc : nullptr);
    }
  });
}

// The merit: each plan's five df32 moments (count, sum x, sum y, sum x^2,
// sum y^2) over its live rays; partials[(block * nlam + l) * 10 + 2q +
// h] the blocks' pairs; the last block writes out[l * 5 + q] in float64.
template <class Ps, class Map, int BLOCK, typename W>
__device__ __forceinline__ void merit_multi(W words, const In12& in,
                                            float* __restrict__ partials,
                                            unsigned int* __restrict__ counter,
                                            double* __restrict__ out,
                                            int64_t n) {
  constexpr int NLAM = Map::nlam;
  __shared__ float scratch[10 * (BLOCK / 32)];
  const int64_t stride = int64_t(gridDim.x) * BLOCK;
  for_plans<Ps, Map>(words, [&](auto tc, int l, W w) {
    using P = typename Ps::template at<decltype(tc)::value>;
    df m[5];
#pragma unroll
    for (int q = 0; q < 5; ++q) m[q] = {0.f, 0.f};
    for (int64_t i = int64_t(blockIdx.x) * BLOCK + threadIdx.x; i < n;
         i += stride) {
      Rays r = load_rays(in, i);
      df tacc;
      trace_plan<P, false>(w, r, tacc);
      if (live(r)) accumulate(m, 1, r);
    }
    block_sum_df(m, scratch,
                 partials + (int64_t(blockIdx.x) * NLAM + l) * 10);
  });
  if (!last_block(counter)) return;
  // one warp a value; lane b promotes blocks b, b + 32, ... exactly
  // (hi + lo is exact in float64) and the warp sums them
  const int lane = threadIdx.x & 31;
  for (int v = threadIdx.x >> 5; v < NLAM * 5; v += BLOCK / 32) {
    const int l = v / 5, q = v % 5;
    double sum = 0.;
    for (int b = lane; b < int(gridDim.x); b += 32) {
      const float* p = partials + (int64_t(b) * NLAM + l) * 10 + 2 * q;
      sum += double(__ldcg(p)) + double(__ldcg(p + 1));
    }
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_down_sync(0xffffffffu, sum, off);
    if (lane == 0) out[v] = sum;
  }
  if (threadIdx.x == 0) *counter = 0u;
}

// The plan words as the chain reads them: straight from the kernel's
// parameters, or (WORDS_STAGED, WORDS_DEVICE) from a copy in shared
// memory made once a block, through a volatile pointer.
template <class Ps, class Map, int AT, int BLOCK, typename F>
__device__ __forceinline__ void with_words(const KernelWords<Ps, Map, AT>& pw,
                                           F&& f) {
  if constexpr (AT == WORDS_DIRECT) {
    f(static_cast<const float*>(pw.w));
  } else {
    constexpr int N = plan_words<Ps, Map>();
    float* s_words;
    if constexpr (AT == WORDS_STAGED) {
      __shared__ float s_static[N];
      s_words = s_static;
    } else {
      extern __shared__ float s_dynamic[];
      s_words = s_dynamic;
    }
    for (int i = threadIdx.x; i < N; i += BLOCK) s_words[i] = pw.w[i];
    __syncthreads();
    f(static_cast<const volatile float*>(s_words));
  }
}

// The trace (K10, K11) of one key.  MINB: the blocks an SM
// __launch_bounds__ asks ptxas to fit (1 at least, as grad_spec.cuh's
// kernels).
template <class Ps, class Map, bool PATH, int AT, int BLOCK, int MINB>
__global__ void __launch_bounds__(BLOCK, MINB) df32_trace_spec(
    const __grid_constant__ KernelWords<Ps, Map, AT> pw, In12 in,
    float* __restrict__ out, int64_t n) {
  with_words<Ps, Map, AT, BLOCK>(pw, [&](auto words) {
    trace_multi<Ps, Map, PATH, BLOCK>(words, in, out, n);
  });
}

// The merit (K12, K13) of one key.
template <class Ps, class Map, int AT, int BLOCK, int MINB>
__global__ void __launch_bounds__(BLOCK, MINB) df32_merit_spec(
    const __grid_constant__ KernelWords<Ps, Map, AT> pw, In12 in,
    float* __restrict__ partials, unsigned int* __restrict__ counter,
    double* __restrict__ out, int64_t n) {
  with_words<Ps, Map, AT, BLOCK>(pw, [&](auto words) {
    merit_multi<Ps, Map, BLOCK>(words, in, partials, counter, out, n);
  });
}

// The kernel parameter of a launch: the host-side plan words copied in,
// or (WORDS_DEVICE) the device words' pointer.
template <class Ps, class Map, int AT>
__host__ inline KernelWords<Ps, Map, AT> kernel_words(const void* words) {
  KernelWords<Ps, Map, AT> pw;
  if constexpr (AT == WORDS_DEVICE)
    pw.w = static_cast<const float*>(words);
  else
    std::memcpy(pw.w, words, sizeof pw.w);
  return pw;
}

}  // namespace

// Trace launchers of one key: NAME(words (nlam, Ps::words) float32: in
// host memory, copied into the launch's parameters, or (WORDS_DEVICE) on
// the device; the 12 input words; out (nlam, 12 or 14 with PATH, n); n,
// grid, stream); NAME_blocks_per_sm(&blocks); NAME_error_string(err).
#define RAYOPT_DF32_TRACE(NAME, PLANS, MAP, PATH, AT, BLOCK, MINB)            \
  extern "C" int NAME##_blocks_per_sm(int* out) {                             \
    return blocks_per_sm(                                                     \
        df32_trace_spec<PLANS, MAP, PATH, AT, BLOCK, MINB>, BLOCK,            \
        words_smem<PLANS, MAP, AT>(), out);                                   \
  }                                                                           \
  extern "C" const char* NAME##_error_string(int err) {                       \
    return cudaGetErrorString(cudaError_t(err));                              \
  }                                                                           \
  extern "C" int NAME(const void* words, IN12_PARAMS, void* out, long long n, \
                      int grid, void* stream) {                               \
    const void* p[12] = IN12_ARRAY;                                           \
    const size_t smem = words_smem<PLANS, MAP, AT>();                         \
    cudaError_t err = allow_smem(                                             \
        df32_trace_spec<PLANS, MAP, PATH, AT, BLOCK, MINB>, smem);            \
    if (err != cudaSuccess) return int(err);                                  \
    df32_trace_spec<PLANS, MAP, PATH, AT, BLOCK, MINB>                        \
        <<<grid, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(           \
            kernel_words<PLANS, MAP, AT>(words), pack_in(p),                  \
            static_cast<float*>(out), int64_t(n));                            \
    return int(cudaGetLastError());                                           \
  }

// Merit launchers of one key: NAME(words as the trace's; the 12 input
// words; partials (grid, nlam, 10) float32; counter (1 zeroed uint32,
// reset by the kernel); out (nlam, 5) float64; n, grid, stream);
// NAME_blocks_per_sm(&blocks); NAME_error_string(err).
#define RAYOPT_DF32_MERIT(NAME, PLANS, MAP, AT, BLOCK, MINB)                  \
  extern "C" int NAME##_blocks_per_sm(int* out) {                             \
    return blocks_per_sm(df32_merit_spec<PLANS, MAP, AT, BLOCK, MINB>, BLOCK, \
                         words_smem<PLANS, MAP, AT>(), out);                  \
  }                                                                           \
  extern "C" const char* NAME##_error_string(int err) {                       \
    return cudaGetErrorString(cudaError_t(err));                              \
  }                                                                           \
  extern "C" int NAME(const void* words, IN12_PARAMS, void* partials,         \
                      void* counter, void* out, long long n, int grid,        \
                      void* stream) {                                         \
    const void* p[12] = IN12_ARRAY;                                           \
    const size_t smem = words_smem<PLANS, MAP, AT>();                         \
    cudaError_t err =                                                         \
        allow_smem(df32_merit_spec<PLANS, MAP, AT, BLOCK, MINB>, smem);       \
    if (err != cudaSuccess) return int(err);                                  \
    df32_merit_spec<PLANS, MAP, AT, BLOCK, MINB>                              \
        <<<grid, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(           \
            kernel_words<PLANS, MAP, AT>(words), pack_in(p),                  \
            static_cast<float*>(partials),                                    \
            static_cast<unsigned int*>(counter), static_cast<double*>(out),   \
            int64_t(n));                                                      \
    return int(cudaGetLastError());                                           \
  }
