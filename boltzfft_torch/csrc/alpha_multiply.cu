// K6 for Hopper: the per-node phase multiply of the rfft + use_pallas route,
// for float and double.
//
// Replaces boltzfft/pallas_kernels.py::_alpha_multiply_kernel, reached
// through alpha_multiply from operator._gain_chunk_pallas.  For a chunk of B
// nodes with separable phases alpha1_b(i, m) = ax[b, i] * ayz[b, m] (m the
// flattened (y, z-half) modes, M2 of them) and a half spectrum f_hat (N, M2):
//
//   a1f[b, i, m] = ax[b, i] * (ayz[b, m] * f_hat[i, m])
//   a2f[b, i, m] = conj(ax[b, i]) * (conj(ayz[b, m]) * f_hat[i, m])
//
// in JAX's order of multiplication (the y/z product first, then x), every
// product and sum rounded on its own (__*_rn: no fma contraction), so the
// kernel gives bitwise what the plain PyTorch version's separate elementwise
// ops give.
//
// What bounds it on this card: bytes.  It writes 4 B N M2 reals and reads
// f_hat, ax and ayz once each in the count of the bound (f_hat is re-read per
// node from L2, 2 N M2 reals per node); per eval at 64^3 / Ns = 12 in double
// (B = 384, N M2 = 135,168) that is 1.66 GB, 0.50 ms at 3.35 TB/s; at 32^3
// 107 MB.  There are 6 real multiplies and 6 adds per output complex pair:
// 0.03 FLOP per byte.
//
// What the design does about it: one thread per mode (i, m) of one node
// (gridDim.y = b), consecutive threads on consecutive m, so the two complex
// stores of a warp are coalesced 16-byte (double) or 8-byte (float) words and
// the f_hat read is coalesced and shared by all nodes through L2.  Nothing is
// staged: there is no reuse within a block to stage for.
//
// The entry point returns cudaGetLastError() of its launch; it launches on
// the given stream, does not synchronise and allocates nothing.

#include "spectral_common.cuh"

namespace {

using bfft::Cplx;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

template <typename T>
__global__ void alpha_multiply_kernel(const typename Cplx<T>::type* __restrict__ ax,
                                      const typename Cplx<T>::type* __restrict__ ayz,
                                      const typename Cplx<T>::type* __restrict__ fh,
                                      typename Cplx<T>::type* __restrict__ a1f,
                                      typename Cplx<T>::type* __restrict__ a2f,
                                      int n, long long m2) {
  using C2 = typename Cplx<T>::type;
  const long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long nm = (long long)n * m2;
  if (p >= nm) return;
  const int b = blockIdx.y;
  const long long i = p / m2;
  const long long m = p % m2;
  const C2 f = fh[p];
  const C2 yz = ayz[b * m2 + m];
  const C2 x = ax[(long long)b * n + i];
  // m1 = ayz * f, m2 = conj(ayz) * f
  const T m1r = sub_rn(mul_rn(yz.x, f.x), mul_rn(yz.y, f.y));
  const T m1i = add_rn(mul_rn(yz.x, f.y), mul_rn(yz.y, f.x));
  const T m2r = add_rn(mul_rn(yz.x, f.x), mul_rn(yz.y, f.y));
  const T m2i = sub_rn(mul_rn(yz.x, f.y), mul_rn(yz.y, f.x));
  C2 o1, o2;
  o1.x = sub_rn(mul_rn(x.x, m1r), mul_rn(x.y, m1i));
  o1.y = add_rn(mul_rn(x.x, m1i), mul_rn(x.y, m1r));
  o2.x = add_rn(mul_rn(x.x, m2r), mul_rn(x.y, m2i));
  o2.y = sub_rn(mul_rn(x.x, m2i), mul_rn(x.y, m2r));
  const long long out = (long long)b * nm + p;
  a1f[out] = o1;
  a2f[out] = o2;
}

template <typename T>
int alpha_multiply(const typename Cplx<T>::type* ax,
                   const typename Cplx<T>::type* ayz,
                   const typename Cplx<T>::type* fh, typename Cplx<T>::type* a1f,
                   typename Cplx<T>::type* a2f, int n_nodes, int n, long long m2,
                   cudaStream_t st) {
  const int pt = 256;
  const long long blocks = ((long long)n * m2 + pt - 1) / pt;
  if (blocks > 0x7fffffffLL || n_nodes > 65535) return cudaErrorInvalidConfiguration;
  alpha_multiply_kernel<T><<<dim3((unsigned)blocks, n_nodes), pt, 0, st>>>(
      ax, ayz, fh, a1f, a2f, n, m2);
  return cudaGetLastError();
}

}  // namespace

#define BFFT_ALPHA_ENTRY(NAME, T, C2)                                          \
  extern "C" int NAME(const void* ax, const void* ayz, const void* fh,         \
                      void* a1f, void* a2f, int n_nodes, int n, int m2,        \
                      void* stream) {                                          \
    return alpha_multiply<T>((const C2*)ax, (const C2*)ayz, (const C2*)fh,     \
                             (C2*)a1f, (C2*)a2f, n_nodes, n, m2,               \
                             (cudaStream_t)stream);                            \
  }

BFFT_ALPHA_ENTRY(bfft_alpha_multiply_f32, float, float2)
BFFT_ALPHA_ENTRY(bfft_alpha_multiply_f64, double, double2)
