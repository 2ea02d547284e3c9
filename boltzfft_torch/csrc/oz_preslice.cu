// K7 for Hopper: a ds complex operand's bf16 mantissa chunks, cut once per
// eval so that every K8/K9/K10 launch of the eval reads them instead of
// re-cutting the same spectrum.
//
// Replaces boltzfft/oz.py::_preslice_kernel and _preslice_kernel_merged
// (preslice_rows).  The operand is a 3-D index space (A, B, K) of float32
// pairs (re hi, re lo, im hi, im lo) read in place through its element
// strides, a the unit-stride axis (the wrapper copies an operand laid out
// otherwise), optionally times a float32 mask read through its own strides
// (a broadcast axis has stride 0).  Rows are r = a * B + b, of K elements.
// Per row the power-of-two scale of oz.row_sigma (per component, or shared
// by both in the merged layout) and sx chunks per element out, as bf16:
//   unmerged: two (A*B, sx*K) arrays, chunk i at columns [i*K, (i+1)*K);
//   merged:   one (A*B, sx*2K) array, block i = [re_i | im_i].
// The ds half path hands over f_hat (Nx, Ny, Nz) as the view (x, z < Nz/2,
// y) with the x/y Nyquist mask (Nx, 1, Ny): the half-z slice, the mask and
// the swap of the last two axes cost no copy and no launch of their own.
// The mask is a float multiply, as the plain version's a * fmask (a
// negative entry under it becomes -0.0, whose chunks are +0.0 all the same:
// the shift trick's (x + m) - m rounds a zero to +0).
//
// What bounds it on this card: bytes.  At 64^3 the half path's operand is
// 2,048 rows of 64: 2 MB read (16 B an element), 3.7 MB written (7 chunks
// of re and im, 2 B each): ~1.7 us at 3.35 TB/s, against ~13 float
// operations per chunk.
//
// What the design does about it: a block stages a run of rows (consecutive
// a at one b) in shared memory, loading along a, the unit-stride axis (x on
// both ds paths), so the reads are coalesced.  A thread steps
// its position in the tile by carries, with no division per element, and
// issues the loads of kLoads elements before it stores any (index
// arithmetic per element, three runtime divisions, with few warps to hide
// it, more than doubled the first version's time).  Then a group of G lanes
// (kernels.oz_preslice.plan's power of two; every thread of the block on a
// row) takes a row: each lane owns runs of V consecutive elements, the row
// maxima come from warp shuffles (max does not depend on order), and each
// chunk of a run is written as one V * 2-byte store (8 bytes at V = 4,
// 64^3; 4 at 32^3: kernels.oz_preslice.plan).  The chunk loop is
// oz_common.cuh's extract_chunks, step for step.
//
// The entry point returns cudaGetLastError() of its launch; it launches on
// the given stream, does not synchronise and allocates nothing.

#include "oz_common.cuh"

namespace {

constexpr int kLoads = 4;  // tile elements a thread loads at once

struct PresliceArgs {
  const float* p[4];  // re hi, re lo, im hi, im lo
  const float* mask;  // nullptr: no mask
  uint16_t* o0;
  uint16_t* o1;
  int A, B, K;
  long long sa, sb, sk;  // the planes' element strides
  long long ma, mb, mk;  // the mask's
  int sx, w, merged;
  int RT;  // rows of a tile, consecutive along a
  int KP;  // shared-memory row pitch (K, odd)
  int G;   // lanes of a row
};

template <int V>
struct Vec;
template <>
struct Vec<1> { using T = uint16_t; };
template <>
struct Vec<2> { using T = uint32_t; };
template <>
struct Vec<4> { using T = uint2; };

// V bf16 (the high halves of exact float chunks) packed for one store,
// element e at the lower address.
template <int V>
__device__ __forceinline__ typename Vec<V>::T pack(const float (&c)[V]) {
  uint32_t u[(V + 1) / 2];
#pragma unroll
  for (int e = 0; e < (V + 1) / 2; ++e) {
    const uint32_t lo = bfft_oz::float_to_bf16_exact(c[2 * e]);
    const uint32_t hi =
        2 * e + 1 < V ? bfft_oz::float_to_bf16_exact(c[2 * e + 1 < V ? 2 * e + 1 : 0]) : 0u;
    u[e] = lo | (hi << 16);
  }
  typename Vec<V>::T out;
  if constexpr (V == 1) out = (uint16_t)u[0];
  if constexpr (V == 2) out = u[0];
  if constexpr (V == 4) out = make_uint2(u[0], u[1]);
  return out;
}

template <int V>
__global__ void preslice_kernel(const PresliceArgs a) {
  extern __shared__ float s_tile[];  // 4 planes x RT rows x KP
  const int plane = a.RT * a.KP;
  // the tile: rows a in [r0, r0 + RT) at one b
  const int tiles = (a.A + a.RT - 1) / a.RT;
  const int r0 = (blockIdx.x % tiles) * a.RT, b = blockIdx.x / tiles;
  const int n_rows = min(a.RT, a.A - r0);
  const long long base = r0 * a.sa + b * a.sb, mbase = r0 * a.ma + b * a.mb;

  // 1. the tile into shared memory, a fastest: a thread walks its (row, k)
  // position by carries (no division past the first) and issues the loads
  // of kLoads elements before it stores any
  int lr = threadIdx.x % a.RT, lk = threadIdx.x / a.RT;
  const int dr = blockDim.x % a.RT, dk = blockDim.x / a.RT;
  while (lk < a.K) {
    float v[kLoads][5];  // 4 planes and the mask
    int at[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      at[u] = -1;
      if (lk < a.K) {
        if (lr < n_rows) {
          const long long off = base + lr * a.sa + lk * a.sk;
#pragma unroll
          for (int q = 0; q < 4; ++q) v[u][q] = __ldg(a.p[q] + off);
          if (a.mask != nullptr) v[u][4] = __ldg(a.mask + mbase + lr * a.ma + lk * a.mk);
          at[u] = lr * a.KP + lk;
        }
        lr += dr;
        lk += dk;
        if (lr >= a.RT) {
          lr -= a.RT;
          ++lk;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (at[u] < 0) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        s_tile[q * plane + at[u]] = a.mask != nullptr ? v[u][q] * v[u][4] : v[u][q];
    }
  }
  __syncthreads();

  // 2. a group of G lanes per row: the maxima by shuffles, then the chunks
  const int lane = threadIdx.x % a.G;
  const int groups = blockDim.x / a.G;
  const int sxK = a.sx * a.K;
  for (int first = 0; first < n_rows; first += groups) {  // uniform trip count
    const int tr = first + (int)threadIdx.x / a.G;
    const bool valid = tr < n_rows;
    const float* row = s_tile + (valid ? tr : 0) * a.KP;
    unsigned mr = 0u, mi = 0u;
    if (valid)
      for (int k = lane * V; k < a.K; k += a.G * V)
#pragma unroll
        for (int e = 0; e < V; ++e) {
          mr = max(mr, __float_as_uint(fabsf(row[k + e])));
          mi = max(mi, __float_as_uint(fabsf(row[2 * plane + k + e])));
        }
    if (a.merged) mr = mi = max(mr, mi);
    for (int off = a.G / 2; off > 0; off /= 2) {
      mr = max(mr, __shfl_xor_sync(0xffffffffu, mr, off));
      mi = max(mi, __shfl_xor_sync(0xffffffffu, mi, off));
    }
    if (!valid) continue;
    const float sr = bfft_oz::pow2_ceil_bits(mr), si = bfft_oz::pow2_ceil_bits(mi);
    const long long r = (long long)(r0 + tr) * a.B + b;
    using VT = typename Vec<V>::T;
    for (int k = lane * V; k < a.K; k += a.G * V) {
      float rh[V], rl[V], ih[V], il[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        rh[e] = row[k + e];
        rl[e] = row[plane + k + e];
        ih[e] = row[2 * plane + k + e];
        il[e] = row[3 * plane + k + e];
      }
      for (int i = 0; i < a.sx; ++i) {
        const float mr_i = ldexpf(1.5f, 23 - a.w * (i + 1)) * sr;  // exact
        const float mi_i = ldexpf(1.5f, 23 - a.w * (i + 1)) * si;
        float cr[V], ci[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          cr[e] = (rh[e] + mr_i) - mr_i;
          rh[e] = rh[e] - cr[e];  // exact
          bfft_oz::two_sum(rh[e], rl[e], rh[e], rl[e]);
          ci[e] = (ih[e] + mi_i) - mi_i;
          ih[e] = ih[e] - ci[e];
          bfft_oz::two_sum(ih[e], il[e], ih[e], il[e]);
        }
        if (a.merged) {
          uint16_t* p = a.o0 + r * (2LL * sxK) + (long long)i * 2 * a.K + k;
          *reinterpret_cast<VT*>(p) = pack<V>(cr);
          *reinterpret_cast<VT*>(p + a.K) = pack<V>(ci);
        } else {
          const long long o = r * sxK + (long long)i * a.K + k;
          *reinterpret_cast<VT*>(a.o0 + o) = pack<V>(cr);
          *reinterpret_cast<VT*>(a.o1 + o) = pack<V>(ci);
        }
      }
    }
  }
}

// Shared memory of a block: 4 planes of RT rows at pitch KP.
size_t smem_bytes(int rows, int kp) { return (size_t)4 * rows * kp * sizeof(float); }

}  // namespace

// The operand: planes p[4] with element strides (sa, sb, sk) over (A, B, K),
// sa the unit stride for coalesced loads; mask (or nullptr) with strides
// (ma, mb, mk).  Outputs o0 (and o1 when unmerged).  Launch
// (kernels.oz_preslice.plan): v elements a lane (1, 2, 4; K % v == 0,
// o0/o1 aligned to 2v bytes), g lanes a row (a power of two up to 32),
// tiles of rt rows along a, threads a block (a multiple of 32 up to 256).
extern "C" int bfft_oz_preslice(const void* rh, const void* rl, const void* ih,
                                const void* il, const void* mask, void* o0, void* o1,
                                int A, int B, int K, int sa, int sb, int sk, int ma, int mb,
                                int mk, int sx, int w, int merged, int v, int g, int rt,
                                int threads, void* stream) {
  if (rh == nullptr || rl == nullptr || ih == nullptr || il == nullptr || o0 == nullptr ||
      (!merged && o1 == nullptr) || A < 1 || B < 1 || K < 1 || sx < 1 ||
      sx > bfft_oz::SX_MAX || w < 1 || rt < 1 || threads < 32 || threads > 256 ||
      threads % 32 || (v != 1 && v != 2 && v != 4) || K % v || g < 1 || g > 32 ||
      (g & (g - 1)))
    return cudaErrorInvalidValue;
  const uintptr_t align = 2u * (uintptr_t)v;
  if ((uintptr_t)o0 % align || (!merged && (uintptr_t)o1 % align))
    return cudaErrorInvalidValue;
  PresliceArgs a;
  a.p[0] = (const float*)rh;
  a.p[1] = (const float*)rl;
  a.p[2] = (const float*)ih;
  a.p[3] = (const float*)il;
  a.mask = (const float*)mask;
  a.o0 = (uint16_t*)o0;
  a.o1 = (uint16_t*)o1;
  a.A = A;
  a.B = B;
  a.K = K;
  a.sa = sa;
  a.sb = sb;
  a.sk = sk;
  a.ma = ma;
  a.mb = mb;
  a.mk = mk;
  a.sx = sx;
  a.w = w;
  a.merged = merged;
  a.RT = rt;
  a.KP = K | 1;
  a.G = g;
  const size_t smem = smem_bytes(rt, a.KP);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const long long blocks = (long long)((A + rt - 1) / rt) * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (v == 4) preslice_kernel<4><<<(unsigned)blocks, threads, smem, st>>>(a);
  else if (v == 2) preslice_kernel<2><<<(unsigned)blocks, threads, smem, st>>>(a);
  else preslice_kernel<1><<<(unsigned)blocks, threads, smem, st>>>(a);
  return cudaGetLastError();
}
