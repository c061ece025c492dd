// The polychromatic weighted-moment forward over a wavelength stack of
// tables (K6) and the per-ray optical path difference on the exit-pupil
// reference sphere (K8) for NVIDIA Hopper (sm_90a), templated on float
// and double, with the row flags read at run time.  Their adjoints (K7,
// K9), like the monochromatic forward (K4) and adjoint (K5), are
// compiled per spec tuple (grad_spec.cuh).
//
// Replaces the JAX package's Pallas TPU kernels
//   K6  rayopt_tpu/ops/pallas_grad.py  _fwd_kernel_multi     (_moments_multi_impl)
//   K8  rayopt_tpu/ops/pallas_grad.py  _opd_kernel           (_opd_impl)
// The plain versions live beside the wrappers in
// rayopt_tpu_torch/ops/cuda_grad.py.
//
// What bounds them on the H100.  K6 is K2 with one more input stream
// (the weight), run once a wavelength: 7 words read a ray, nothing
// written, bound by instruction throughput like K2.  K8 is K1's chain
// with 6 words in and 3 out a ray.
//
// What the design does about it.
//  * One thread per ray, a grid-stride loop over structure-of-arrays
//    components: coalesced loads and stores, each ray read once.
//  * K6 reads each ray (and its weight) once into registers and runs the
//    K4 chain once per table of the stack (all staged together in shared
//    memory, sharing the first wavelength's flags); it keeps each
//    thread's per-wavelength moments in its own shared-memory column and
//    writes (grid, nlam, 5) partials that the caller sums.
//  * K8 traces rows 1..S-2 summing the optical path (sum t_j
//    n_before_j), steps to the image row (its axial offset, its
//    transverse offset only when the row is off axis, its rotation),
//    moves to the reference sphere's centre and intercepts the sphere in
//    closed form (step_vjp.cuh sphere_tail); it writes k = -(path + ti
//    n_image)/lam_scale and the landing x, y.  The sphere centre, radius
//    and lam_scale arrive as a device (5,) vector: no host sync.  A ray
//    that misses the sphere is NaN, as a vignetted one.
//  * IEEE division and square root, no fast math.
//
// Interface: plain extern "C" launchers, loaded with ctypes; each
// launches on the given stream, synchronises nothing, allocates
// nothing, and returns cudaGetLastError() (0 = launched).

#include "step_vjp.cuh"

namespace {

constexpr int MAX_BLOCK = 256;

// K6: K4's weighted moments for each table of an nlam stack, one ray
// read once; partials[(blockIdx.x * nlam + l) * 5 + q].
template <typename T>
__global__ void weighted_moments_multi_kernel(
    const T* __restrict__ table, const int* __restrict__ flags, int nsurf,
    int nlam, int clip, const T* __restrict__ ix, const T* __restrict__ iy,
    const T* __restrict__ iz, const T* __restrict__ iux,
    const T* __restrict__ iuy, const T* __restrict__ iuz,
    const T* __restrict__ w, T* __restrict__ partials, int64_t n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = blockDim.x;
  T* s_tab = reinterpret_cast<T*>(smem);
  T* s_red = s_tab + nlam * nsurf * ROW;          // 5 * nlam * nb
  int* s_flags = reinterpret_cast<int*>(s_red + 5 * nlam * nb);
  for (int r = 0; r < 5 * nlam; ++r) s_red[r * nb + threadIdx.x] = T(0);
  stage_table(table, flags, nsurf, s_tab, s_flags, nlam);
  const int64_t stride = int64_t(gridDim.x) * nb;
  for (int64_t i = int64_t(blockIdx.x) * nb + threadIdx.x; i < n;
       i += stride) {
    const T x0 = ix[i], y0 = iy[i], z0 = iz[i];
    const T ux0 = iux[i], uy0 = iuy[i], uz0 = iuz[i];
    const T wi = w[i];
    for (int l = 0; l < nlam; ++l) {
      T x = x0, y = y0, z = z0, ux = ux0, uy = uy0, uz = uz0, tacc;
      trace_ray(s_tab + l * nsurf * ROW, s_flags, nsurf, clip != 0, x, y, z,
                ux, uy, uz, tacc);
      if (isfinite(x) && isfinite(y) && isfinite(uz)) {
        T* m = s_red + 5 * l * nb + threadIdx.x;
        m[0] += wi;
        m[nb] += wi * x;
        m[2 * nb] += wi * y;
        m[3 * nb] += wi * x * x;
        m[4 * nb] += wi * y * y;
      }
    }
  }
  block_sum_rows(s_red, 5 * nlam, partials + int64_t(blockIdx.x) * 5 * nlam);
}

// K8: per-ray k, lx, ly (see the header).
template <typename T>
__global__ void opd_chain_kernel(
    const T* __restrict__ table, const int* __restrict__ flags, int nsurf,
    int clip, const T* __restrict__ ix, const T* __restrict__ iy,
    const T* __restrict__ iz, const T* __restrict__ iux,
    const T* __restrict__ iuy, const T* __restrict__ iuz,
    const T* __restrict__ aux_in, T* __restrict__ ok, T* __restrict__ olx,
    T* __restrict__ oly, int64_t n) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_tab = reinterpret_cast<T*>(smem);
  T* s_aux = s_tab + nsurf * ROW;                  // AUX
  int* s_flags = reinterpret_cast<int*>(s_aux + AUX);
  if (threadIdx.x < AUX) s_aux[threadIdx.x] = aux_in[threadIdx.x];
  stage_table(table, flags, nsurf, s_tab, s_flags);
  const T* pimg = s_tab + (nsurf - 1) * ROW;
  const int fimg = s_flags[nsurf - 1];
  const bool first_rot = s_flags[0] & F_ROTATED;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    T s[6] = {ix[i], iy[i], iz[i], iux[i], iuy[i], iuz[i]};
    if (first_rot) {
      rot_apply_t(s_tab + P_ROT, s[0], s[1], s[2]);
      rot_apply_t(s_tab + P_ROT, s[3], s[4], s[5]);
    }
    T tacc = T(0);
    for (int j = 1; j < nsurf - 1; ++j)
      surface_step(s_tab + j * ROW, s_flags[j], clip != 0, s[0], s[1], s[2],
                   s[3], s[4], s[5], tacc);
    const SphereTail<T> o = sphere_tail(pimg, fimg, s_aux, s);
    ok[i] = -(tacc + o.ti * pimg[P_NB]) / s_aux[4];
    olx[i] = o.px + o.ti * o.dx;
    oly[i] = o.py + o.ti * o.dy;
  }
}

size_t opd_smem(int nsurf, size_t word) {
  return (nsurf * ROW + AUX) * word + nsurf * sizeof(int);
}

size_t moments_multi_smem(int nsurf, int nlam, int block, size_t word) {
  return size_t(nlam) * (nsurf * ROW + 5 * size_t(block)) * word +
         nsurf * sizeof(int);
}

template <typename T>
int launch_moments_multi(const void* table, const void* flags, int nsurf,
                         int nlam, int clip, const void* x, const void* y,
                         const void* z, const void* ux, const void* uy,
                         const void* uz, const void* w, void* partials,
                         long long n, int grid, int block, void* stream) {
  if (block <= 0 || (block & (block - 1)) || nlam < 1)
    return int(cudaErrorInvalidValue);
  const size_t smem = moments_multi_smem(nsurf, nlam, block, sizeof(T));
  cudaError_t err = allow_smem(weighted_moments_multi_kernel<T>, smem);
  if (err != cudaSuccess) return int(err);
  weighted_moments_multi_kernel<T><<<grid, block, smem,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), static_cast<const int*>(flags), nsurf,
      nlam, clip, static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(z), static_cast<const T*>(ux),
      static_cast<const T*>(uy), static_cast<const T*>(uz),
      static_cast<const T*>(w), static_cast<T*>(partials), int64_t(n));
  return int(cudaGetLastError());
}

}  // namespace

// K6 launchers: table (nlam, nsurf, ROW), flags (nsurf,), 6 rays, w,
// partials (grid, nlam, 5).
#define MOMENTS_MULTI_LAUNCHER(NAME, T)                                       \
  extern "C" int NAME(const void* table, const void* flags, int nsurf,       \
                      int nlam, int clip, const void* x, const void* y,      \
                      const void* z, const void* ux, const void* uy,         \
                      const void* uz, const void* w, void* partials,         \
                      long long n, int grid, int block, void* stream) {      \
    return launch_moments_multi<T>(table, flags, nsurf, nlam, clip, x, y, z, \
                                   ux, uy, uz, w, partials, n, grid, block,  \
                                   stream);                                  \
  }

MOMENTS_MULTI_LAUNCHER(weighted_moments_multi_f32, float)
MOMENTS_MULTI_LAUNCHER(weighted_moments_multi_f64, double)

// K8 launchers: table (nsurf, ROW), flags (nsurf,), 6 rays, aux (AUX,),
// k, lx, ly (n,).
#define OPD_CHAIN_LAUNCHER(NAME, T)                                           \
  extern "C" int NAME(const void* table, const void* flags, int nsurf,       \
                      int clip, const void* x, const void* y, const void* z, \
                      const void* ux, const void* uy, const void* uz,        \
                      const void* aux, void* k, void* lx, void* ly,          \
                      long long n, int grid, int block, void* stream) {      \
    if (block <= 0 || block > MAX_BLOCK || nsurf < 3)                        \
      return int(cudaErrorInvalidValue);                                     \
    opd_chain_kernel<T><<<grid, block, opd_smem(nsurf, sizeof(T)),           \
                          static_cast<cudaStream_t>(stream)>>>(              \
        static_cast<const T*>(table), static_cast<const int*>(flags), nsurf, \
        clip, static_cast<const T*>(x), static_cast<const T*>(y),            \
        static_cast<const T*>(z), static_cast<const T*>(ux),                 \
        static_cast<const T*>(uy), static_cast<const T*>(uz),                \
        static_cast<const T*>(aux), static_cast<T*>(k),                      \
        static_cast<T*>(lx), static_cast<T*>(ly), int64_t(n));               \
    return int(cudaGetLastError());                                          \
  }

OPD_CHAIN_LAUNCHER(opd_chain_f32, float)
OPD_CHAIN_LAUNCHER(opd_chain_f64, double)
