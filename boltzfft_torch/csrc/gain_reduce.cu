// K5 for Hopper: the weighted node reduction of the rfft + use_pallas route,
// for float and double.
//
// Replaces boltzfft/pallas_kernels.py::_gain_reduce_kernel, reached through
// gain_reduce from operator._gain_chunk_pallas (and timed alone by
// cli/loop_benchmark.py).  For a chunk of B nodes and M flattened modes:
//
//   out[l] = sum_b  w_b(l) h[b, l],
//   w_b(l) = (amp gw_b) sin(a) / a,   a = (coef rho_b) |l| + eps,
//   amp = 4 pi b_gamma, coef = pi / (2 L),
//
// with beta1 computed in registers, never stored.
//
// What bounds it on this card: bytes.  It reads h once, 2 B M reals (0.83 GB
// at 64^3 / Ns = 12 in double, M = 64 * 64 * 33: 0.25 ms at 3.35 TB/s; 53 MB
// at 32^3), and writes 2 M.  Per (b, l) it does one sin, one divide and about
// eight multiply-adds: about 4 operations per 16 bytes in double.
//
// What the design does about it: one thread per mode l walks the nodes b in
// order, so every sum runs in one thread in a fixed order (no atomics, no
// cross-block pass) and the result is bitwise reproducible.  Consecutive
// threads read consecutive h[b, l], a coalesced stream.  A block stages
// node_block (rho, gw) pairs in shared memory per pass; node_block changes
// only how many pairs a pass stages, never the arithmetic or its order, so
// the result is bitwise the same for every node_block (the TPU kernel sums
// each node block from zero instead, so its result moves with the block).
// M need not be a multiple of anything: the ragged last block is masked, and
// nothing is padded.
//
// The entry point returns cudaGetLastError() of its launch; it launches on
// the given stream, does not synchronise and allocates nothing.

#include "spectral_common.cuh"

namespace {

using bfft::Cplx;

template <typename T>
__global__ void gain_reduce_kernel(const typename Cplx<T>::type* __restrict__ h,
                                   const T* __restrict__ rho,
                                   const T* __restrict__ gw,
                                   const T* __restrict__ norm_l,
                                   typename Cplx<T>::type* __restrict__ out,
                                   int n_nodes, long long m, int node_block,
                                   T coef, T amp, T eps) {
  using C2 = typename Cplx<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_rho = reinterpret_cast<T*>(smem_raw);
  T* s_gw = s_rho + node_block;
  const long long l = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const bool valid = l < m;
  const T nl = valid ? norm_l[l] : T(0);
  C2 acc;
  acc.x = 0;
  acc.y = 0;
  for (int b0 = 0; b0 < n_nodes; b0 += node_block) {
    const int nb = min(node_block, n_nodes - b0);
    __syncthreads();  // the previous pass is done with the staged pairs
    for (int k = threadIdx.x; k < nb; k += blockDim.x) {
      s_rho[k] = rho[b0 + k];
      s_gw[k] = gw[b0 + k];
    }
    __syncthreads();
    if (valid) {
      for (int k = 0; k < nb; ++k) {
        const T arg = (coef * s_rho[k]) * nl + eps;
        const T w = (amp * s_gw[k]) * bfft::dev_sin(arg) / arg;
        const C2 v = h[(long long)(b0 + k) * m + l];
        acc.x = acc.x + w * v.x;
        acc.y = acc.y + w * v.y;
      }
    }
  }
  if (valid) out[l] = acc;
}

template <typename T>
int gain_reduce(const typename Cplx<T>::type* h, const T* rho, const T* gw,
                const T* norm_l, typename Cplx<T>::type* out, int n_nodes,
                long long m, int node_block, double coef, double amp,
                double eps, cudaStream_t st) {
  const int pt = 256;
  const long long blocks = (m + pt - 1) / pt;
  if (blocks > 0x7fffffffLL || node_block < 1) return cudaErrorInvalidConfiguration;
  const size_t smem = 2 * (size_t)node_block * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      gain_reduce_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  gain_reduce_kernel<T><<<(unsigned)blocks, pt, smem, st>>>(
      h, rho, gw, norm_l, out, n_nodes, m, node_block, (T)coef, (T)amp,
      (T)eps);
  return cudaGetLastError();
}

}  // namespace

#define BFFT_REDUCE_ENTRY(NAME, T, C2)                                         \
  extern "C" int NAME(const void* h, const void* rho, const void* gw,          \
                      const void* norm_l, void* out, int n_nodes, int m,       \
                      int node_block, double coef, double amp, double eps,     \
                      void* stream) {                                          \
    return gain_reduce<T>((const C2*)h, (const T*)rho, (const T*)gw,           \
                          (const T*)norm_l, (C2*)out, n_nodes, m, node_block,  \
                          coef, amp, eps, (cudaStream_t)stream);               \
  }

BFFT_REDUCE_ENTRY(bfft_gain_reduce_f32, float, float2)
BFFT_REDUCE_ENTRY(bfft_gain_reduce_f64, double, double2)
