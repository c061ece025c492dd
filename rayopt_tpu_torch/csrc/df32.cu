// Double-single ("df32") parity-grade trace for NVIDIA Hopper (sm_90a):
// the df32 trace (K10) and the fused df32 spot-moment merit (K12), with
// their flags read at run time.  Their polychromatic twins K11 and K13
// are compiled per plan key (df32_spec.cuh).
//
// Replaces the JAX package's Pallas TPU kernels
//   K10  rayopt_tpu/ops/df32.py  pallas_trace_df32             (kernel :1094)
//   K12  rayopt_tpu/ops/df32.py  pallas_trace_df32_merit       (kernel :1285)
// and computes, word for word, what rayopt_tpu_torch/ops/df32.py computes
// (the plain versions; the wrappers are in ops/cuda_df32.py).
//
// A df32 number is an (hi, lo) pair of floats carrying ~2^-47 relative
// precision; the arithmetic, one surface step and the moment sums are
// in df32_common.cuh, here with Dekker's split in two_prod
// (RAYOPT_DF32_FMA 0).
//
// What bounds it on the H100.  One ray through the double Gauss costs
// 9.7k (fast plan) to 11.1k (exact) float32 operations with the path, as
// written here (chip_smoke.df32_chain_ops counts the FMA form: 5.6k to
// 6.6k), against 48 bytes read and 56 written (K10 with the path): ~100
// operations a byte, five times the ridge of the H100 SXM data sheet's
// 67 TFLOP/s and 3.35 TB/s.  The kernels are bound by operations.
//
// What the design does about it.
//  * One thread per ray, a grid-stride loop; the 12 state words and the
//    2 path words stay in registers through the whole chain, so each ray
//    is read once and (K10) written once.
//  * The plan is packed on the host into DW float words and one int32 of
//    flags a step (kind, flat, conic, alternate, rotation mode and
//    signed permutation, off-axis, clip, fast), staged once per block
//    into shared memory.  Every thread reads the same address (a
//    broadcast) and the flags are uniform across the warp, so branching
//    on them costs no divergence.
//  * K12 reduces deterministically, without atomics: a df32 accumulator
//    per thread, warp shuffles with df32 add, then one warp over the
//    block's warps; one (hi, lo) pair per moment per block, which the
//    wrapper promotes to float64 and sums.
//
// Interface: plain extern "C" launchers, loaded with ctypes; each
// launches on the given stream, synchronises nothing, allocates nothing,
// and returns cudaGetLastError() (0 = launched).

#define RAYOPT_DF32_FMA 0
#include "df32_common.cuh"

namespace {

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
  const float* w = words + (nsteps - 1) * DW;
  frame_apply<false>(w, fl, r.x, r.y, r.z);
  frame_apply<false>(w, fl, r.ux, r.uy, r.uz);
}

// Stage a plan of nsteps steps (words and flags) into shared memory.
__device__ __forceinline__ void stage_plan(const float* words,
                                           const int* flags, int nsteps,
                                           float* s_words, int* s_flags) {
  for (int i = threadIdx.x; i < nsteps * DW; i += blockDim.x)
    s_words[i] = words[i];
  for (int i = threadIdx.x; i < nsteps; i += blockDim.x)
    s_flags[i] = flags[i];
  __syncthreads();
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
  stage_plan(words, flags, nsteps, s_words, s_flags);
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    Rays r = load_rays(in, i);
    df tacc;
    trace_df<PATH>(s_words, s_flags, nsteps, r, tacc);
    store_rays(out, n, i, r, PATH ? &tacc : nullptr);
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
  stage_plan(words, flags, nsteps, s_words, s_flags);
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

size_t trace_smem(int nsteps) {
  return size_t(nsteps) * (DW * sizeof(float) + sizeof(int));
}

size_t merit_smem(int nsteps, int block) {
  return trace_smem(nsteps) + 10 * sizeof(float) * (block / 32);
}

bool bad_block(int block) {
  return block <= 0 || block > 1024 || block % 32;
}

}  // namespace

// K10: words (nsteps, DW) float32, flags (nsteps,) int32, the 12 input
// words, out (12 or 14 with_path, n) float32.
extern "C" int df32_trace_final(const void* words, const void* flags,
                                int nsteps, int with_path, IN12_PARAMS,
                                void* out, long long n, int grid, int block,
                                void* stream) {
  if (bad_block(block) || nsteps < 1) return int(cudaErrorInvalidValue);
  const void* p[12] = IN12_ARRAY;
  const size_t smem = trace_smem(nsteps);
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

// K12: partials (grid, 5, 2) float32.
extern "C" int df32_merit(const void* words, const void* flags, int nsteps,
                          IN12_PARAMS, void* partials, long long n, int grid,
                          int block, void* stream) {
  if (bad_block(block) || nsteps < 1) return int(cudaErrorInvalidValue);
  const void* p[12] = IN12_ARRAY;
  const size_t smem = merit_smem(nsteps, block);
  cudaError_t err = allow_smem(df32_merit_kernel, smem);
  if (err != cudaSuccess) return int(err);
  df32_merit_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(words), static_cast<const int*>(flags), nsteps,
      pack_in(p), static_cast<float*>(partials), n);
  return int(cudaGetLastError());
}
