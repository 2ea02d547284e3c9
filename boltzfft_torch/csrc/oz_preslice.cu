// K7 for Hopper: a ds complex operand's bf16 mantissa chunks, cut once per
// eval so that every K8/K9 launch of the eval reads them instead of
// re-cutting the same spectrum.
//
// Replaces boltzfft/oz.py::_preslice_kernel and _preslice_kernel_merged
// (preslice_rows).  Rows of K float32 pairs (re hi, re lo, im hi, im lo) in;
// per row the power-of-two scale of oz.row_sigma (per component, or shared by
// both in the merged layout) and sx chunks per element out, as bf16:
//   unmerged: two (rows, sx*K) arrays, chunk i at columns [i*K, (i+1)*K);
//   merged:   one (rows, sx*2K) array, block i = [re_i | im_i].
//
// What bounds it on this card: bytes.  It reads 16 B and writes 4*sx B per
// element (at 64^3, 131,072 rows of 64: 8 MB in, 14.7 MB out, ~7 us at 3.35
// TB/s) and does ~13 float operations per chunk.
//
// What the design does about it: one block per tile of rows; the row maxima
// by atomicMax on the float bits in shared memory (max is order-free, so the
// result is deterministic), then one thread per element runs the chunk loop
// of oz_common.cuh's extract_chunks (the K8 kernels use the same function),
// reads coalesced and writes each chunk where the layout puts it.
//
// The entry point returns cudaGetLastError() of its launch; it launches on
// the given stream, does not synchronise and allocates nothing.

#include "oz_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void preslice_kernel(const float* __restrict__ rh, const float* __restrict__ rl,
                                const float* __restrict__ ih, const float* __restrict__ il,
                                uint16_t* __restrict__ o0, uint16_t* __restrict__ o1,
                                int rows, int K, int sx, int w, int merged, int tr_rows) {
  __shared__ unsigned s_max[2 * kThreads];
  const int row0 = blockIdx.x * tr_rows;
  const int nr = min(tr_rows, rows - row0);
  for (int r = threadIdx.x; r < 2 * tr_rows; r += blockDim.x) s_max[r] = 0u;
  __syncthreads();
  for (int idx = threadIdx.x; idx < nr * K; idx += blockDim.x) {
    const long long off = (long long)row0 * K + idx;
    const int r = idx / K;
    atomicMax(&s_max[r], __float_as_uint(fabsf(rh[off])));
    atomicMax(&s_max[merged ? r : tr_rows + r], __float_as_uint(fabsf(ih[off])));
  }
  __syncthreads();
  float cr[bfft_oz::SX_MAX], ci[bfft_oz::SX_MAX];
  for (int idx = threadIdx.x; idx < nr * K; idx += blockDim.x) {
    const long long off = (long long)row0 * K + idx;
    const int r = idx / K, k = idx % K;
    const float sr = bfft_oz::pow2_ceil_bits(s_max[r]);
    const float si = merged ? sr : bfft_oz::pow2_ceil_bits(s_max[tr_rows + r]);
    bfft_oz::extract_chunks(rh[off], rl[off], sr, w, sx, cr, 1);
    bfft_oz::extract_chunks(ih[off], il[off], si, w, sx, ci, 1);
    const long long row = row0 + r;
    for (int i = 0; i < sx; ++i) {
      if (merged) {
        uint16_t* p = o0 + row * (2LL * sx * K) + (long long)i * 2 * K;
        p[k] = bfft_oz::float_to_bf16_exact(cr[i]);
        p[K + k] = bfft_oz::float_to_bf16_exact(ci[i]);
      } else {
        o0[row * ((long long)sx * K) + (long long)i * K + k] = bfft_oz::float_to_bf16_exact(cr[i]);
        o1[row * ((long long)sx * K) + (long long)i * K + k] = bfft_oz::float_to_bf16_exact(ci[i]);
      }
    }
  }
}

}  // namespace

extern "C" int bfft_oz_preslice(const void* rh, const void* rl, const void* ih,
                                const void* il, void* o0, void* o1, int rows, int K,
                                int sx, int w, int merged, void* stream) {
  if (rows < 1 || K < 1 || sx < 1 || sx > bfft_oz::SX_MAX || (!merged && o1 == nullptr))
    return cudaErrorInvalidValue;
  const int tr = K >= kThreads ? 1 : kThreads / K;
  const long long blocks = (rows + tr - 1) / tr;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  preslice_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)rh, (const float*)rl, (const float*)ih, (const float*)il,
      (uint16_t*)o0, (uint16_t*)o1, rows, K, sx, w, merged, tr);
  return cudaGetLastError();
}
