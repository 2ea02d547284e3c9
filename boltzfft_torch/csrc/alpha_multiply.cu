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
// ops give.  a1f and a2f are the two halves of one (2, B, N, M2) buffer.
//
// What bounds it on this card: bytes.  It writes 4 B N M2 reals and reads
// f_hat, ax and ayz once each in the count of the bound; per eval at 64^3 /
// Ns = 12 in double (B = 384, N M2 = 135,168) that is 1.66 GB, 0.50 ms at
// 3.35 TB/s; at 32^3 107 MB.  There are 6 real multiplies and 6 adds per
// output complex pair: 0.03 FLOP per byte.
//
// What the design does about it:
//  - a thread owns V consecutive elements p of the flattened (i, m) space
//    (V = 2 in float where M2 is even and f_hat and ayz are 16-byte
//    aligned, else 1), splits p into (i, m) once, keeps its f_hat values in
//    registers and walks its nb nodes: per node one load of ax[b, i] (a few
//    distinct rows a warp, from L1), one coalesced load of ayz[b, m..m+V)
//    and two 16-byte stores (two complex64 in float, one complex128 in
//    double), consecutive threads on consecutive addresses;
//  - the grid is (vector tiles of `threads`, node blocks of nb), the plan
//    the caller's (kernels.alpha_multiply.plan): nb = 1 (f_hat is read
//    from L2 for each node), larger only past 65535 nodes.  Measured at the
//    route's chunks (tools/ds_kernels_ab.py, NVIDIA H100 80GB HBM3, 700 W):
//    a thread that walked nb = 2-16 nodes wrote as many nodes' rows at once
//    and lost 1-9% (64^3 double: 0.5615 ms at nb = 1, 0.6081 at 16);
//  - any B, N and M2 fit (the last tile and the last node block are
//    ragged).
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

constexpr int kMaxThreads = 256;

// V consecutive complex values at p (one 16-byte access where V = 2 in float)
template <typename C2, int V>
__device__ __forceinline__ void load_v(const C2* __restrict__ p, C2 (&v)[V]) {
  if constexpr (V == 2) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = make_float2(q.x, q.y);
    v[1] = make_float2(q.z, q.w);
  } else {
    v[0] = __ldg(p);
  }
}

template <typename C2, int V>
__device__ __forceinline__ void store_v(C2* __restrict__ p, const C2 (&v)[V]) {
  if constexpr (V == 2) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0].x, v[0].y, v[1].x, v[1].y);
  } else {
    *p = v[0];
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
alpha_multiply_kernel(const typename Cplx<T>::type* __restrict__ ax,
                      const typename Cplx<T>::type* __restrict__ ayz,
                      const typename Cplx<T>::type* __restrict__ fh,
                      typename Cplx<T>::type* __restrict__ a1f,
                      typename Cplx<T>::type* __restrict__ a2f, int n_nodes, int n, int m2,
                      int nb) {
  using C2 = typename Cplx<T>::type;
  const int p = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (p >= n * m2) return;
  const int i = p / m2;
  const int m = p - i * m2;
  C2 f[V];
  load_v<C2, V>(fh + p, f);
  const size_t nm = (size_t)n * m2;
  const int b0 = blockIdx.y * nb;
  const int b1 = min(b0 + nb, n_nodes);
#pragma unroll 2
  for (int b = b0; b < b1; ++b) {
    const C2 x = __ldg(ax + (size_t)b * n + i);
    C2 yz[V], o1[V], o2[V];
    load_v<C2, V>(ayz + (size_t)b * m2 + m, yz);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      // m1 = ayz * f, m2 = conj(ayz) * f
      const T m1r = sub_rn(mul_rn(yz[k].x, f[k].x), mul_rn(yz[k].y, f[k].y));
      const T m1i = add_rn(mul_rn(yz[k].x, f[k].y), mul_rn(yz[k].y, f[k].x));
      const T m2r = add_rn(mul_rn(yz[k].x, f[k].x), mul_rn(yz[k].y, f[k].y));
      const T m2i = sub_rn(mul_rn(yz[k].x, f[k].y), mul_rn(yz[k].y, f[k].x));
      o1[k].x = sub_rn(mul_rn(x.x, m1r), mul_rn(x.y, m1i));
      o1[k].y = add_rn(mul_rn(x.x, m1i), mul_rn(x.y, m1r));
      o2[k].x = add_rn(mul_rn(x.x, m2r), mul_rn(x.y, m2i));
      o2[k].y = sub_rn(mul_rn(x.x, m2i), mul_rn(x.y, m2r));
    }
    store_v<C2, V>(a1f + b * nm + p, o1);
    store_v<C2, V>(a2f + b * nm + p, o2);
  }
}

template <typename T>
int alpha_multiply(const typename Cplx<T>::type* ax, const typename Cplx<T>::type* ayz,
                   const typename Cplx<T>::type* fh, typename Cplx<T>::type* out,
                   int n_nodes, int n, int m2, int vec, int threads, int nb, cudaStream_t st) {
  const long long nm = (long long)n * m2;
  if (n_nodes < 1 || n < 1 || m2 < 1 || nb < 1 || threads < 32 || threads > kMaxThreads ||
      threads % 32 || nm > 0x7ffffe00LL || (long long)n_nodes * m2 > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (!(vec == 1 || (vec == 2 && sizeof(T) == 4 && m2 % 2 == 0)))
    return cudaErrorInvalidValue;
  const long long xblocks = (nm / vec + threads - 1) / threads;
  const long long node_blocks = ((long long)n_nodes + nb - 1) / nb;
  if (node_blocks > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)xblocks, (unsigned)node_blocks);
  typename Cplx<T>::type* a2f = out + (size_t)n_nodes * nm;
  if constexpr (sizeof(T) == 4) {
    if (vec == 2) {
      alpha_multiply_kernel<T, 2><<<grid, threads, 0, st>>>(ax, ayz, fh, out, a2f, n_nodes, n,
                                                            m2, nb);
      return cudaGetLastError();
    }
  }
  alpha_multiply_kernel<T, 1><<<grid, threads, 0, st>>>(ax, ayz, fh, out, a2f, n_nodes, n, m2,
                                                        nb);
  return cudaGetLastError();
}

}  // namespace

#define BFFT_ALPHA_ENTRY(NAME, T, C2)                                                  \
  extern "C" int NAME(const void* ax, const void* ayz, const void* fh, void* out,      \
                      int n_nodes, int n, int m2, int vec, int threads, int nb,        \
                      void* stream) {                                                  \
    return alpha_multiply<T>((const C2*)ax, (const C2*)ayz, (const C2*)fh, (C2*)out,   \
                             n_nodes, n, m2, vec, threads, nb, (cudaStream_t)stream);  \
  }

BFFT_ALPHA_ENTRY(bfft_alpha_multiply_f32, float, float2)
BFFT_ALPHA_ENTRY(bfft_alpha_multiply_f64, double, double2)
