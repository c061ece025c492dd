// The polychromatic twin of the fused trace (K3) for NVIDIA Hopper
// (sm_90a), templated on float and double, with the row flags read at
// run time.  The fused trace (K1) and the fused spot-moment merit (K2)
// are compiled per spec tuple (grad_spec.cuh).
//
// Replaces the JAX package's Pallas TPU kernel
//   K3  rayopt_tpu/ops/pallas_trace.py  _multi_kernel           (pallas_trace_multi)
// and computes, ray for ray and wavelength for wavelength, what
// rayopt_tpu_torch.ops.kernels.surface_step_spec computes (the plain
// version lives beside the wrapper in rayopt_tpu_torch/ops/cuda_trace.py).
//
// What bounds it on the H100.  Each ray reads 6 words and (trace mode)
// writes 7 a wavelength; each of the ~12 traced surfaces costs ~60
// flops a wavelength.  In float32 that is ~12*60 flops per 52 bytes a
// wavelength, ~14 flop/byte, against 67 TFLOP/s / 3.35 TB/s = 20 for
// the card; but the chain is bound by instruction issue, not by its
// flops (K1 and K2, which writes nothing a ray, take about the same
// time).  In float64 (~34 TFLOP/s of FP64 FMA, 2x the bytes) it is ALU
// bound.
//
// What the design does about it.
//  * One thread per ray, a grid-stride loop, structure-of-arrays
//    components: every load and store is coalesced, each ray is read
//    from HBM exactly once for all wavelengths and written once a
//    wavelength, and no intermediate state leaves registers (the
//    single-pass property the TPU kernel got from VMEM residency).
//  * The tables of the wavelength stack (17 words a row) and one int32
//    of static SurfaceSpec flags a row (the specs of the first
//    wavelength) are staged once per block into shared memory; every
//    thread reads the same address (a broadcast), and the flags are
//    uniform across the warp, so branching on them costs no divergence.
//    K1, K2 and K4-K9 (grad_spec.cuh) compile the same step with the
//    flags as compile-time constants, one library a spec tuple; K3
//    keeps one build for every table.
//  * IEEE division and square root, no fast math: vignetted rays are
//    NaN and must stay NaN through every later surface, which the
//    guarded square root (trace_common.cuh; NaN in, NaN out) relies on.
//  * No aperture clip, as the TPU kernel.  Trace mode writes 7
//    coalesced outputs a wavelength; merit mode keeps each thread's
//    per-wavelength count moments in its own shared-memory column and
//    tree-sums them per block into (grid, nlam, 5) partials.  The trace,
//    which is what bounds it on this card, runs nlam times: expect ~nlam
//    x K2.
//
// Interface: plain extern "C" launchers, loaded with ctypes; each
// launches on the given stream, synchronises nothing, allocates
// nothing, and returns cudaGetLastError() (0 = launched).

#include "trace_common.cuh"

namespace {

// K3: one ray, read once, through each of nlam tables (no clip).
// Trace mode: out[(l * 7 + c) * n + i], c = x, y, z, ux, uy, uz, t.
// Merit mode: partials[(blockIdx.x * nlam + l) * 5 + q], the count
// moments (n_live, sum x, sum y, sum x^2, sum y^2) of wavelength l.
template <typename T, bool MERIT>
__global__ void trace_multi_kernel(const T* __restrict__ table,
                                   const int* __restrict__ flags, int nsurf,
                                   int nlam, const T* __restrict__ ix,
                                   const T* __restrict__ iy,
                                   const T* __restrict__ iz,
                                   const T* __restrict__ iux,
                                   const T* __restrict__ iuy,
                                   const T* __restrict__ iuz,
                                   T* __restrict__ out, int64_t n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = blockDim.x;
  T* s_tab = reinterpret_cast<T*>(smem);
  T* s_red = s_tab + nlam * nsurf * ROW;          // MERIT: 5 * nlam * nb
  int* s_flags = reinterpret_cast<int*>(s_red + (MERIT ? 5 * nlam * nb : 0));
  if (MERIT)
    for (int r = 0; r < 5 * nlam; ++r) s_red[r * nb + threadIdx.x] = T(0);
  stage_table(table, flags, nsurf, s_tab, s_flags, nlam);
  const int64_t stride = int64_t(gridDim.x) * nb;
  for (int64_t i = int64_t(blockIdx.x) * nb + threadIdx.x; i < n;
       i += stride) {
    const T x0 = ix[i], y0 = iy[i], z0 = iz[i];
    const T ux0 = iux[i], uy0 = iuy[i], uz0 = iuz[i];
    for (int l = 0; l < nlam; ++l) {
      T x = x0, y = y0, z = z0, ux = ux0, uy = uy0, uz = uz0, tacc;
      trace_ray(s_tab + l * nsurf * ROW, s_flags, nsurf, false, x, y, z, ux,
                uy, uz, tacc);
      if (MERIT) {
        if (isfinite(x) && isfinite(y) && isfinite(uz)) {
          T* m = s_red + 5 * l * nb + threadIdx.x;
          m[0] += T(1);
          m[nb] += x;
          m[2 * nb] += y;
          m[3 * nb] += x * x;
          m[4 * nb] += y * y;
        }
      } else {
        T* o = out + int64_t(l) * 7 * n + i;
        o[0] = x; o[n] = y; o[2 * n] = z;
        o[3 * n] = ux; o[4 * n] = uy; o[5 * n] = uz;
        o[6 * n] = tacc;
      }
    }
  }
  if (MERIT)
    block_sum_rows(s_red, 5 * nlam,
                   out + int64_t(blockIdx.x) * 5 * nlam);
}

size_t multi_smem(int nsurf, int nlam, int block, bool merit, size_t word) {
  return (size_t(nlam) * nsurf * ROW + (merit ? 5 * size_t(nlam) * block : 0)) *
             word + nsurf * sizeof(int);
}

template <typename T, bool MERIT>
int launch_trace_multi(const void* table, const void* flags, int nsurf,
                       int nlam, const void* x, const void* y, const void* z,
                       const void* ux, const void* uy, const void* uz,
                       void* out, long long n, int grid, int block,
                       void* stream) {
  if (block <= 0 || (block & (block - 1)) || nlam < 1)
    return int(cudaErrorInvalidValue);
  const size_t smem = multi_smem(nsurf, nlam, block, MERIT, sizeof(T));
  cudaError_t err = allow_smem(trace_multi_kernel<T, MERIT>, smem);
  if (err != cudaSuccess) return int(err);
  trace_multi_kernel<T, MERIT><<<grid, block, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), static_cast<const int*>(flags), nsurf,
      nlam, static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(z), static_cast<const T*>(ux),
      static_cast<const T*>(uy), static_cast<const T*>(uz),
      static_cast<T*>(out), int64_t(n));
  return int(cudaGetLastError());
}

}  // namespace

// K3 launchers: table (nlam, nsurf, ROW), flags (nsurf,), 6 rays, out
// ((nlam, 7, n) in trace mode, (grid, nlam, 5) in merit mode).
#define TRACE_MULTI_LAUNCHER(NAME, T, MERIT)                                  \
  extern "C" int NAME(const void* table, const void* flags, int nsurf,       \
                      int nlam, const void* x, const void* y, const void* z, \
                      const void* ux, const void* uy, const void* uz,        \
                      void* out, long long n, int grid, int block,           \
                      void* stream) {                                        \
    return launch_trace_multi<T, MERIT>(table, flags, nsurf, nlam, x, y, z,  \
                                        ux, uy, uz, out, n, grid, block,     \
                                        stream);                             \
  }

TRACE_MULTI_LAUNCHER(trace_multi_f32, float, false)
TRACE_MULTI_LAUNCHER(trace_multi_f64, double, false)
TRACE_MULTI_LAUNCHER(trace_multi_merit_f32, float, true)
TRACE_MULTI_LAUNCHER(trace_multi_merit_f64, double, true)

extern "C" const char* trace_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
