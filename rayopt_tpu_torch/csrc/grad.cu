// The per-ray optical path difference on the exit-pupil reference
// sphere (K8) for NVIDIA Hopper (sm_90a), templated on float and double,
// with the row flags read at run time.  Its adjoint (K9), like the
// moment kernels (K2, K4, K6) and the other adjoints (K5, K7), is
// compiled per spec tuple (grad_spec.cuh).
//
// Replaces the JAX package's Pallas TPU kernel
//   K8  rayopt_tpu/ops/pallas_grad.py  _opd_kernel           (_opd_impl)
// The plain version lives beside the wrapper in
// rayopt_tpu_torch/ops/cuda_grad.py.
//
// What bounds it on the H100.  K8 is K1's chain with 6 words in and 3
// out a ray, bound by instruction throughput like K1.
//
// What the design does about it.
//  * One thread per ray, a grid-stride loop over structure-of-arrays
//    components: coalesced loads and stores, each ray read once.
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

}  // namespace

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
