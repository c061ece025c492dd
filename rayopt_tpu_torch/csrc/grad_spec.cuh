// The weighted-moment forward (K4) and its analytic adjoint (K5) for
// NVIDIA Hopper (sm_90a), specialized at compile time on one key: the
// dtype, the SurfaceSpec tuple (one word of trace_common.cuh flags a
// row), the aperture clip and the block size; K5 also on the parameter
// slots it reduces and on whether it writes the ray and weight
// cotangents.
//
// Replaces the JAX package's Pallas TPU kernels
//   K4  rayopt_tpu/ops/pallas_grad.py  _fwd_kernel      (_moments_impl)
//   K5  rayopt_tpu/ops/pallas_grad.py  _adjoint_kernel  (_moments_bwd)
// which the JAX package specializes on the same things (specs, clip and
// diff_fields).  rayopt_tpu_torch.ops.cuda_spec writes a translation
// unit a key that instantiates the templates below with the row words
// as a template parameter pack (Chain<...>) and exports launchers named
// by the key's hash; nvcc builds it at first use.  The plain versions
// and the torch model of K5 live in rayopt_tpu_torch/ops/cuda_grad.py.
//
// What bounds them on the H100.  K4 reads 7 words a ray and writes
// nothing; K5 reads 7 and writes 7 a ray when asked for the ray
// cotangents, else nothing.  Both are bound by instruction issue: the
// chain costs ~540 operations a ray on the double Gauss (K5 ~4x that:
// the forward, then each row's recompute and reverse), with an IEEE
// division and square roots a row.
//
// What the design does about it.
//  * The row loop unrolls over the parameter pack: surface_step and
//    surface_step_vjp (the one body K1-K3 and K6-K9 run with flags read
//    at run time) get each row's flags as a std::integral_constant, so
//    every flag branch folds and each row's code is straight-line.  The
//    slots a row does not reduce are dead code and compile away.
//  * K5 keeps the state entering each row in dynamic shared memory,
//    [row][component][thread] (consecutive lanes on consecutive words,
//    no bank conflicts), sized by the table's rows: no per-thread array
//    on the stack, no local-memory traffic.  The staged table and the
//    saved states are read through volatile pointers: unrolled, the
//    rows' words would otherwise be hoisted out of the grid-stride loop
//    and the states forwarded in registers, past the register file.
//  * K5 accumulates each thread's live slots in registers over its
//    grid-stride rays (compile-time indices), reduces them across the
//    warp and the block once at the end, and the last block to finish
//    (__threadfence, then an integer atomicAdd on a counter it resets)
//    sums the blocks' partials in block order and writes the (rows, 6)
//    result, zeros where a slot is not live.  Deterministic for a
//    given grid; one launch a call, no float atomics.  K4 does the same
//    for its five moments.
//  * A dead ray (non-finite final x, y or uz) skips its reverse sweep;
//    without ray cotangents K5 writes nothing a ray.
//  * IEEE division and square root, no fast math.
//  * Tensor cores, TMA and wgmma do not apply: each ray's chain is
//    scalar arithmetic whose only products are 3x3 rotations, and a
//    ray is read once, coalesced, as 7 words.
//
// Interface: plain extern "C" launchers (RAYOPT_SPEC_MOMENTS,
// RAYOPT_SPEC_ADJOINT), loaded with ctypes; each launches on the given
// stream, synchronises nothing, allocates nothing, and returns
// cudaGetLastError() (0 = launched).

#pragma once

#include <type_traits>
#include <utility>

#include "step_vjp.cuh"

namespace {

constexpr int LIVE_SHIFT = 8;  // a row word's live slots: cuda_spec.LIVE_SHIFT
constexpr int FLAG_MASK = (1 << LIVE_SHIFT) - 1;

// The rows of one key: W holds a word a row, its flags in the low
// LIVE_SHIFT bits and above them the K5 slots (c, k, offset x, y, z,
// mu) that row reduces.
template <int... W>
struct Chain {
  static constexpr int rows = sizeof...(W);
};

template <int... W>
__host__ __device__ constexpr int word_at(Chain<W...>, int j) {
  constexpr int w[] = {W...};
  return w[j];
}

template <class C>
__host__ __device__ constexpr int flags_at(int j) {
  return word_at(C{}, j) & FLAG_MASK;
}

template <class C>
__host__ __device__ constexpr int live_at(int j) {
  return (word_at(C{}, j) >> LIVE_SHIFT) & ((1 << SLOTS) - 1);
}

__host__ __device__ constexpr int popc6(int m) {
  int c = 0;
  for (int q = 0; q < SLOTS; ++q) c += (m >> q) & 1;
  return c;
}

// index of slot (j, q) among the live slots, rows first; -1 if dead
template <class C>
__host__ __device__ constexpr int slot_index(int j, int q) {
  int b = 0;
  for (int i = 0; i < j; ++i) b += popc6(live_at<C>(i));
  return (live_at<C>(j) >> q) & 1 ? b + popc6(live_at<C>(j) & ((1 << q) - 1))
                                  : -1;
}

template <class C>
__host__ __device__ constexpr int live_count() {
  int b = 0;
  for (int i = 0; i < C::rows; ++i) b += popc6(live_at<C>(i));
  return b;
}

// f(std::integral_constant<int, I>{}) for each I of the sequence, in order
template <typename F, int... I>
__device__ __forceinline__ void static_for(std::integer_sequence<int, I...>,
                                           F&& f) {
  (f(std::integral_constant<int, I>{}), ...);
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

// The grid-wide sum, fused into the launch: each block writes its nv
// partial sums (s_part) to partials[blockIdx.x][.]; the last block to
// finish sums all blocks' partials in block order (one warp a value,
// lane b summing blocks b, b + 32, ...) back into s_part, resets the
// counter and returns true.  Every thread of the block must call it.
template <typename T, int BLOCK>
__device__ __forceinline__ bool grid_sum(T* s_part, int nv,
                                         T* __restrict__ partials,
                                         unsigned int* __restrict__ counter) {
  __shared__ bool s_last;
  for (int q = threadIdx.x; q < nv; q += BLOCK)
    partials[int64_t(blockIdx.x) * nv + q] = s_part[q];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return false;
  const int lane = threadIdx.x & 31;
  for (int q = threadIdx.x >> 5; q < nv; q += BLOCK / 32) {
    T v = T(0);
    for (int b = lane; b < int(gridDim.x); b += 32)
      v += __ldcg(partials + int64_t(b) * nv + q);
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) s_part[q] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) *counter = 0u;
  return true;
}

// The forward chain for one ray (trace_ray with compile-time flags),
// up to the last row's frame exclusive; save(j) runs before row j.
// tab: the staged table, read through a volatile pointer so that each
// row's words are loaded where they are used (surface_step).
template <typename T, class C, bool CLIP, typename Save>
__device__ __forceinline__ void chain_forward(const volatile T* tab, T* s,
                                              Save&& save) {
  if (flags_at<C>(0) & F_ROTATED) {
    rot_apply_t(tab + P_ROT, s[0], s[1], s[2]);
    rot_apply_t(tab + P_ROT, s[3], s[4], s[5]);
  }
  T tacc = T(0);
  static_for(std::make_integer_sequence<int, C::rows - 1>{}, [&](auto i) {
    constexpr int j = decltype(i)::value + 1;
    save(j);
    surface_step(tab + j * ROW, RowFlags<C, j>{}, CLIP, s[0], s[1], s[2],
                 s[3], s[4], s[5], tacc);
  });
}

// K4: trace, then the five weighted moments over live rays.
// MINB: the blocks an SM __launch_bounds__ asks ptxas to fit.  Give it
// (1 at least): with the block size alone ptxas capped the float32 K5
// at 80 registers and spilled; with a minimum of one block it takes 86
// and spills nothing.
template <typename T, class C, bool CLIP, int BLOCK, int MINB>
__global__ void __launch_bounds__(BLOCK, MINB) weighted_moments_spec(
    const T* __restrict__ table, const T* __restrict__ ix,
    const T* __restrict__ iy, const T* __restrict__ iz,
    const T* __restrict__ iux, const T* __restrict__ iuy,
    const T* __restrict__ iuz, const T* __restrict__ w,
    T* __restrict__ partials, unsigned int* __restrict__ counter,
    T* __restrict__ out, int64_t n) {
  constexpr int S = C::rows;
  __shared__ T s_tab[S * ROW];
  __shared__ T s_red[BLOCK / 32 * 5];
  __shared__ T s_part[5];
  for (int i = threadIdx.x; i < S * ROW; i += BLOCK) s_tab[i] = table[i];
  __syncthreads();
  const volatile T* tab = s_tab;
  const volatile T* rl = tab + (S - 1) * ROW + P_ROT;
  T m[5] = {T(0), T(0), T(0), T(0), T(0)};
  const int64_t stride = int64_t(gridDim.x) * BLOCK;
  for (int64_t i = int64_t(blockIdx.x) * BLOCK + threadIdx.x; i < n;
       i += stride) {
    T s[6] = {ix[i], iy[i], iz[i], iux[i], iuy[i], iuz[i]};
    chain_forward<T, C, CLIP>(tab, s, [](int) {});
    if (flags_at<C>(S - 1) & F_ROTATED) {
      rot_apply(rl, s[0], s[1], s[2]);
      rot_apply(rl, s[3], s[4], s[5]);
    }
    if (isfinite(s[0]) && isfinite(s[1]) && isfinite(s[5])) {
      const T wi = w[i];
      m[0] += wi;
      m[1] += wi * s[0];
      m[2] += wi * s[1];
      m[3] += wi * s[0] * s[0];
      m[4] += wi * s[1] * s[1];
    }
  }
  block_sum<T, BLOCK>(m, s_red, s_part);
  if (grid_sum<T, BLOCK>(s_part, 5, partials, counter) && threadIdx.x < 5)
    out[threadIdx.x] = s_part[threadIdx.x];
}

// K5: the analytic adjoint of K4's moments dotted with ct (5 values).
// out: (rows, SLOTS) parameter cotangents, zero where a slot is not
// live; with RAYS the six ray and the weight cotangents a ray (zeros
// for a dead ray).  Dynamic shared memory: the saved states,
// (rows - 1) * 6 * BLOCK words.
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
  const T ct0 = ct[0], ct1 = ct[1], ct2 = ct[2], ct3 = ct[3], ct4 = ct[4];
  const volatile T* tab = s_tab;
  const volatile T* rl = tab + (S - 1) * ROW + P_ROT;
  constexpr bool first_rot = flags_at<C>(0) & F_ROTATED;
  constexpr bool last_rot = flags_at<C>(S - 1) & F_ROTATED;
  T acc[NA];
#pragma unroll
  for (int q = 0; q < NA; ++q) acc[q] = T(0);
  const int64_t stride = int64_t(gridDim.x) * BLOCK;
  for (int64_t i = int64_t(blockIdx.x) * BLOCK + threadIdx.x; i < n;
       i += stride) {
    // (a) forward recompute, keeping the state entering each row
    T s[6] = {ix[i], iy[i], iz[i], iux[i], iuy[i], iuz[i]};
    chain_forward<T, C, CLIP>(tab, s, [&](int j) {
#pragma unroll
      for (int q = 0; q < 6; ++q) saved[((j - 1) * 6 + q) * BLOCK] = s[q];
    });
    if (last_rot) {
      rot_apply(rl, s[0], s[1], s[2]);
      rot_apply(rl, s[3], s[4], s[5]);
    }
    // (b) liveness; (c) seed the cotangents from the moment cotangents
    const bool live = isfinite(s[0]) && isfinite(s[1]) && isfinite(s[5]);
    T g[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
    T gw = T(0);
    if (live) {
      const T xl = s[0], yl = s[1];
      const T wi = w[i];
      g[0] = wi * (ct1 + T(2) * xl * ct3);
      g[1] = wi * (ct2 + T(2) * yl * ct4);
      if (RAYS)
        gw = ct0 + xl * ct1 + yl * ct2 + xl * xl * ct3 + yl * yl * ct4;
      if (last_rot) rot_apply_t(rl, g[0], g[1], g[2]);
      // (d) reverse sweep, rows S-1 .. 1, each row's live slots summed
      // into this thread's accumulators
      static_for(std::make_integer_sequence<int, S - 1>{}, [&](auto r) {
        constexpr int j = S - 1 - decltype(r)::value;
        T st[6], pg[SLOTS];
#pragma unroll
        for (int q = 0; q < 6; ++q) st[q] = saved[((j - 1) * 6 + q) * BLOCK];
        surface_step_vjp(tab + j * ROW, RowFlags<C, j>{}, st, g, pg);
        static_for(std::make_integer_sequence<int, SLOTS>{}, [&](auto c) {
          constexpr int q = decltype(c)::value;
          constexpr int k = slot_index<C>(j, q);
          if constexpr (k >= 0) acc[k] += pg[q];
        });
      });
      if (first_rot) {
        rot_apply(tab + P_ROT, g[0], g[1], g[2]);
        rot_apply(tab + P_ROT, g[3], g[4], g[5]);
      }
    }
    // (f) per-ray cotangents (zeros for a dead ray), when asked
    if (RAYS) {
      ogx[i] = g[0]; ogy[i] = g[1]; ogz[i] = g[2];
      ogux[i] = g[3]; oguy[i] = g[4]; oguz[i] = g[5];
      ogw[i] = gw;
    }
  }
  // (e) the live slots: block, then grid, once
  block_sum<T, BLOCK>(acc, s_red, s_part);
  if (grid_sum<T, BLOCK>(s_part, NL, partials, counter)) {
    static_for(std::make_integer_sequence<int, S * SLOTS>{}, [&](auto p) {
      constexpr int idx = decltype(p)::value;
      constexpr int k = slot_index<C>(idx / SLOTS, idx % SLOTS);
      if (idx % BLOCK == int(threadIdx.x)) {
        if constexpr (k >= 0) {
          out[idx] = s_part[k];
        } else {
          out[idx] = T(0);
        }
      }
    });
  }
}

// K5's saved states: (rows - 1) * 6 words a thread
template <typename T, class C, int BLOCK>
constexpr size_t adjoint_dynamic_smem() {
  return size_t(C::rows - 1) * 6 * BLOCK * sizeof(T);
}

template <typename K>
__host__ inline int blocks_per_sm(K kernel, int block, size_t smem,
                                  int* out) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return int(err);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, block,
                                                           smem));
}

}  // namespace

// K4 launchers of one key: NAME(table (rows, ROW), 6 rays, w, partials
// (grid, 5), counter (1 zeroed uint32, reset by the kernel), out (5,),
// n, grid, stream); NAME_blocks_per_sm(&blocks); NAME_error_string(err).
#define RAYOPT_SPEC_MOMENTS(NAME, T, CHAIN, CLIP, BLOCK, MINB)                \
  extern "C" int NAME##_blocks_per_sm(int* out) {                             \
    return blocks_per_sm(weighted_moments_spec<T, CHAIN, CLIP, BLOCK, MINB>,  \
                         BLOCK, 0, out);                                      \
  }                                                                           \
  extern "C" const char* NAME##_error_string(int err) {                       \
    return cudaGetErrorString(cudaError_t(err));                              \
  }                                                                           \
  extern "C" int NAME(const void* table, const void* x, const void* y,        \
                      const void* z, const void* ux, const void* uy,          \
                      const void* uz, const void* w, void* partials,          \
                      void* counter, void* out, long long n, int grid,        \
                      void* stream) {                                         \
    weighted_moments_spec<T, CHAIN, CLIP, BLOCK, MINB>                        \
        <<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(              \
            static_cast<const T*>(table), static_cast<const T*>(x),           \
            static_cast<const T*>(y), static_cast<const T*>(z),               \
            static_cast<const T*>(ux), static_cast<const T*>(uy),             \
            static_cast<const T*>(uz), static_cast<const T*>(w),              \
            static_cast<T*>(partials), static_cast<unsigned int*>(counter),   \
            static_cast<T*>(out), int64_t(n));                                \
    return int(cudaGetLastError());                                           \
  }

// K5 launchers of one key: NAME(table, 6 rays, w, ct (5,), partials
// (grid, live slots), counter, out (rows, SLOTS), 6 ray + 1 weight
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
