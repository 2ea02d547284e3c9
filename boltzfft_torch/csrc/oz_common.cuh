// Device code shared by the ds engine's kernels (K7 oz_preslice.cu, K8
// oz_contract.cu, K9 oz_gmain3.cu, K10 oz_gmain12.cu, K11 oz_hadamard.cu,
// K12 oz_hadamard_half.cu): the float32 error-free transformations, the
// Ozaki chunk extraction, and one tile of the sliced contraction.
//
// Every source that includes this header is compiled with --fmad=false
// (_build.py).  The EFTs are right only when each + - * is rounded on its
// own: nvcc's default contraction of a*b + c into one FMA would change
// ds.mul's e + (x.hi*y.lo + x.lo*y.hi), fold the chunk constant into the
// shift trick, and make the kernels differ from their plain PyTorch
// versions.
//
// The tile's exact chunk dots run on the tensor cores (mma.sync m16n8k16,
// bf16 in, float32 out).  Why that is exact: every chunk and every matrix
// slice is an integer of at most 8 bits (|c| <= 2^w = 128) times its unit,
// so a product is exact and at most 2^14 units of its level; a tensor-core
// step sums at most 32 of them into a zeroed fragment (< 2^19 units), far
// inside the adder's alignment window, so no bit is truncated; and the
// float32 adds that gather the steps into a level are exact below 2^24
// units, the bound oz.merge_ok / oz.unmerged_ok check.
//
// The numbers of boltzfft_torch/oz.py: chunk width w (7), at most 7 chunks
// of an operand (sx = min(7, cmax + 1)), at most 8 matrix slices (sm), and
// nlev = cmax + 1 <= 8 levels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bfft_oz {

constexpr int SX_MAX = 7;
constexpr int SM_MAX = 8;

// ---- float32 EFTs (boltzfft_torch/ds.py, op for op) --------------------

__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = a + b;
  const float bb = s - a;
  e = (a - (s - bb)) + (b - bb);
}

__device__ __forceinline__ void quick_two_sum(float a, float b, float& s, float& e) {
  s = a + b;
  e = b - (s - a);
}

// (hi, lo) += plain float p: two_sum, then quick_two_sum(s, e + lo)
__device__ __forceinline__ void add_float(float& hi, float& lo, float p) {
  float s, e;
  two_sum(hi, p, s, e);
  quick_two_sum(s, e + lo, hi, lo);
}

// ds add: two_sum(hi), e + (lo + lo), quick_two_sum
__device__ __forceinline__ void ds_add(float ah, float al, float bh, float bl,
                                       float& sh, float& sl) {
  float s, e;
  two_sum(ah, bh, s, e);
  e = e + (al + bl);
  quick_two_sum(s, e, sh, sl);
}

__device__ __forceinline__ void split(float a, float& h, float& l) {
  const float c = a * 4097.0f;  // 2^12 + 1, Dekker's constant for float32
  h = c - (c - a);
  l = a - h;
}

// ds multiply: Dekker two_prod of the high words, + (ah*bl + al*bh)
__device__ __forceinline__ void ds_mul(float ah, float al, float bh, float bl,
                                       float& ph, float& pl) {
  const float p = ah * bh;
  float h1, l1, h2, l2;
  split(ah, h1, l1);
  split(bh, h2, l2);
  float e = ((h1 * h2 - p) + h1 * l2 + l1 * h2) + l1 * l2;
  e = e + (ah * bl + al * bh);
  quick_two_sum(p, e, ph, pl);
}

// t = phase * x (or conj(phase) * x) in ds, the TPU kernel's _k_phase_cmul:
// the four products phase-first, then re = rr - ii, im = ri + ir.
__device__ __forceinline__ void phase_cmul(float prh, float prl, float pih, float pil,
                                           bool conj, float xrh, float xrl, float xih,
                                           float xil, float& trh, float& trl, float& tih,
                                           float& til) {
  if (conj) {
    pih = -pih;
    pil = -pil;
  }
  float rrh, rrl, iih, iil, rih, ril, irh, irl;
  ds_mul(prh, prl, xrh, xrl, rrh, rrl);
  ds_mul(pih, pil, xih, xil, iih, iil);
  ds_mul(prh, prl, xih, xil, rih, ril);
  ds_mul(pih, pil, xrh, xrl, irh, irl);
  ds_add(rrh, rrl, -iih, -iil, trh, trl);
  ds_add(rih, ril, irh, irl, tih, til);
}

// ---- Ozaki chunks ------------------------------------------------------

// Smallest power of two strictly above |x| from the bits of |x| (a float32
// >= 0 read as unsigned), exponent clamped to [64, 254]: oz.pow2_ceil.
__device__ __forceinline__ float pow2_ceil_bits(unsigned bits) {
  int e = (int)((bits >> 23) & 0xFFu) + 1;
  e = e < 64 ? 64 : (e > 254 ? 254 : e);
  return __int_as_float(e << 23);
}

// Chunks hold at most 8 significant bits, so dropping the low half is exact.
__device__ __forceinline__ uint16_t float_to_bf16_exact(float x) {
  return (uint16_t)(__float_as_uint(x) >> 16);
}

__device__ __forceinline__ void store_chunk(float* p, float c) { *p = c; }
__device__ __forceinline__ void store_chunk(uint16_t* p, float c) { *p = float_to_bf16_exact(c); }

// The sx chunks of hi + lo at scale sig (oz.chunk_rows): the shift trick
// with the mid-binade constant 1.5 * 2^(23 - w(i+1)) * sig, whose ulp is the
// chunk unit, then the low word folded into the residual.  Stored as float32
// or, exactly, as bf16.
template <typename Out>
__device__ __forceinline__ void extract_chunks(float hi, float lo, float sig, int w, int sx,
                                               Out* out, int stride) {
  for (int i = 0; i < sx; ++i) {
    const float mi = ldexpf(1.5f, 23 - w * (i + 1)) * sig;  // exact
    const float c = (hi + mi) - mi;
    store_chunk(out + i * stride, c);
    hi = hi - c;  // exact
    two_sum(hi, lo, hi, lo);
  }
}

// ---- one tile of the sliced contraction --------------------------------

// A tile of `nrows` consecutive rows (from `row0`) of one contraction stage,
// and the output columns [c0, c0 + lg) of it, against one node's matrix
// slices.  Inputs: float32 planes at row stride K (ih == nullptr: a real
// input), or presliced bf16 chunks (pre0/pre1: unmerged, sx*K per row each;
// pre0 alone: merged, sx*2K per row).  Row r of the stage reads input row
// (r / iB) * isa + (r % iB) * isb (the identity by default).  Phased mode
// (prh != nullptr, complex planes in, unmerged): the operand is t = phase *
// x (conj(phase) when `conj`), the phase a ds row of K values (prh, prl,
// pih, pil) shared by the tile's rows.  Output (oih == nullptr: real output
// only) of row r and column l at (r / B) * sa + (r % B) * sb + l * sl.  The
// slices j < nsl of the column group are in shared memory (load_slices).
struct OzTile {
  const float *rh, *rl, *ih, *il;
  const uint16_t *pre0, *pre1;
  const uint16_t *mre, *mim;  // (sm, K, L)
  float *orh, *orl, *oih, *oil;
  int row0, nrows, tr_rows;   // tile start, rows in it, rows a tile holds (a multiple of 16)
  int K, L, sm, sx, w, fold_tail, merged, nlev;  // nlev = cmax + 1 levels
  long long B, sa, sb, sl;
  long long iB = 1, isa = 1, isb = 0;
  const float *prh = nullptr, *prl = nullptr, *pih = nullptr, *pil = nullptr;
  int conj = 0;
  int c0 = 0, lg = 0, nsl = 0;  // the column group, and the slices kept
};

__device__ __forceinline__ long long in_row(const OzTile& t, int r) {
  const long long q = t.row0 + r;
  return t.iB == 1 ? q * t.isa : (q / t.iB) * t.isa + (q % t.iB) * t.isb;
}

// The tile's complex operand at (input offset off, column k): x, or
// phase * x in phased mode.
__device__ __forceinline__ void operand(const OzTile& t, long long off, int k, float& rh,
                                        float& rl, float& ih, float& il) {
  rh = t.rh[off];
  rl = t.rl[off];
  ih = t.ih[off];
  il = t.il[off];
  if (t.prh != nullptr)
    phase_cmul(t.prh[k], t.prl[k], t.pih[k], t.pil[k], t.conj, rh, rl, ih, il, rh, rl, ih, il);
}

// ---- the tile's geometry -------------------------------------------------

// A block of OZ_THREADS threads; each warp owns one 16 x 16 output tile (two
// mma D fragments side by side, sharing their A fragments) at a time.
constexpr int OZ_WARPS = 8;
constexpr int OZ_THREADS = 32 * OZ_WARPS;
constexpr size_t OZ_SMEM_MAX = 232448;  // dynamic shared memory one block may use

// K padded to the mma depth (16) and L to a warp tile's width (16).  The
// rows of the bf16 operands in shared memory (chunks: K values; slices: L
// values) have an odd number of 16-byte units, so that the eight rows an
// ldmatrix phase reads lie on distinct banks.
__host__ __device__ inline int padded_k(int K) { return (K + 15) & ~15; }
__host__ __device__ inline int padded_l(int L) { return (L + 15) & ~15; }
__host__ __device__ inline int k_stride(int K) { return padded_k(K) + 8; }
__host__ __device__ inline int l_stride(int L) { return padded_l(L) + 8; }

// Rows of a full tile for lg output columns: as many 16-row strips as keep
// every warp on one 16 x 16 output tile (one strip from lg = 128 on; above
// it the warps take the output tiles in turns).
__host__ __device__ inline int tile_rows(int lg) {
  const int nt = padded_l(lg) / 16;
  return 16 * (nt >= OZ_WARPS ? 1 : OZ_WARPS / nt);
}

// Shared memory of a tile: the nsl slices of a column group of lg columns,
// re and im, 2 * nsl * padded_k(K) bf16 rows of l_stride(lg); the chunks of
// tr_rows rows, 2 * sx * tr_rows bf16 rows of k_stride(K); the row maxima,
// 2 * tr_rows words.  The one count of it: the kernels size their launches
// and K10 its z block (bfft_oz_gmain12_fits) by it.
__host__ __device__ inline size_t tile_smem_bytes(int K, int lg, int sx, int tr_rows, int nsl) {
  return sizeof(uint16_t) * (2 * (size_t)nsl * padded_k(K) * l_stride(lg)
                             + 2 * (size_t)sx * tr_rows * k_stride(K))
         + 2 * sizeof(unsigned) * tr_rows;
}

// How a stage of `rows` rows and L columns is cut, with `extra` bytes of
// shared memory in use beside the tile: column groups of lg columns (all L
// unless the slices then do not fit; else halved, in multiples of 8), and
// row tiles of tr rows (a full tile, or all the rows rounded up to 16 where
// they are fewer; halved, down to 16, until it fits).
struct OzPlan {
  int lg, tr;
};
__host__ __device__ inline OzPlan oz_plan(int K, int L, int sx, int nsl, int rows, size_t extra) {
  OzPlan p;
  p.lg = L;
  while (p.lg > 8 && extra + tile_smem_bytes(K, p.lg, sx, 16, nsl) > OZ_SMEM_MAX)
    p.lg = ((p.lg + 1) / 2 + 7) & ~7;
  const int need = (rows + 15) & ~15, full = tile_rows(p.lg);
  p.tr = need < full ? need : full;
  while (p.tr > 16 && extra + tile_smem_bytes(K, p.lg, sx, p.tr, nsl) > OZ_SMEM_MAX)
    p.tr = (p.tr / 2 + 15) & ~15;
  return p;
}

// ---- tensor-core steps ---------------------------------------------------

// The A operand (16 x 16, row-major) of an m16n8k16 product from bf16 rows
// at stride ks in shared memory, from row 0, column 0 of p: one ldmatrix.x4,
// lanes 0-15 naming rows 0-15 of columns 0-7, lanes 16-31 of columns 8-15.
__device__ __forceinline__ void load_a(const uint16_t* p, int ks, int lane, unsigned (&a)[4]) {
  const uint16_t* q = p + ((lane & 7) + (lane & 8)) * ks + ((lane >> 4) << 3);
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(q));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

// The B operand (16 x 8) of the same product from a row-major (K, L) bf16
// slice at row stride ls, from row 0, column 0 of p: one ldmatrix.x2.trans,
// lanes 0-15 naming rows 0-15.
__device__ __forceinline__ void load_b(const uint16_t* p, int ls, int lane, unsigned (&b)[2]) {
  const uint16_t* q = p + (lane & 15) * ls;
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(q));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(addr)
               : "memory");
}

// d = a b + c, one warp-wide m16n8k16 product, bf16 in, float32 sums.
// Thread (lane) holds d at rows lane/4 (d[0], d[1]) and lane/4 + 8 (d[2],
// d[3]), columns 2 (lane % 4) and one more.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2], const float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(c[0]),
        "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// 16 bytes from global to shared memory without passing through registers
// (cp.async); src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint16_t* dst, const uint16_t* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(d), "l"(src), "r"(src_bytes)
               : "memory");
}

// Columns [c0, c0 + lg) of the slices j < nsl of the tile's matrix, re and
// im, into shared memory (slice j component c at (2j + c) * padded_k(K) *
// l_stride(lg)), zero-padded to padded_k(K) rows (a row past K would meet
// the zero chunks of the padded K: it must not hold a NaN): cp.async 16
// bytes at a time where the source allows it, else plain loads, which also
// zero the columns past lg.  Those feed only output columns the tile does
// not store.  Every thread of the block takes part; the slices are ready on
// return.
__device__ __forceinline__ void load_slices(const OzTile& t, float* smem) {
  uint16_t* s_m = reinterpret_cast<uint16_t*>(smem);
  const int K = t.K, Kp = padded_k(K), lg = t.lg, lp = padded_l(lg), ls = l_stride(lg);
  const int ms = Kp * ls, nt = blockDim.x, tid = threadIdx.x;
  const bool vec = lg % 8 == 0 && t.L % 8 == 0 && t.c0 % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(t.mre) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(t.mim) & 15) == 0;
  __syncthreads();  // the previous column group or stage is done with them
  if (vec) {
    const int g = lg / 8, per = Kp * g;
    for (int idx = tid; idx < 2 * t.nsl * per; idx += nt) {
      const int sc = idx / per, rem = idx - sc * per, k = rem / g, c = rem - k * g;
      const uint16_t* src = ((sc & 1) ? t.mim : t.mre) + (size_t)(sc >> 1) * K * t.L;
      const bool in = k < K;
      cp_async16(s_m + (size_t)sc * ms + k * ls + 8 * c,
                 in ? src + (size_t)k * t.L + t.c0 + 8 * c : src, in ? 16 : 0);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    const int per = Kp * lp;
    for (int idx = tid; idx < 2 * t.nsl * per; idx += nt) {
      const int sc = idx / per, rem = idx - sc * per, k = rem / lp, c = rem - k * lp;
      const uint16_t* src = ((sc & 1) ? t.mim : t.mre) + (size_t)(sc >> 1) * K * t.L;
      s_m[(size_t)sc * ms + k * ls + c] =
          (k < K && c < lg) ? src[(size_t)k * t.L + t.c0 + c] : (uint16_t)0;
    }
  }
  __syncthreads();
}

// Folds level d of a list into (hi, lo) in the TPU kernel's order: (hi,
// lo) += (neg ? -level : level) for d < ft; the levels d >= ft are summed
// in float32 first (tail) and added once after the last (fold_tail).
__device__ __forceinline__ void fold_level(int d, int ft, bool neg, const float (&acc)[2][4],
                                           float (&tail)[2][4], float (&hi)[2][4],
                                           float (&lo)[2][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (d >= ft) {
        tail[h][e] = d > ft ? tail[h][e] + acc[h][e] : acc[h][e];
      } else {
        add_float(hi[h][e], lo[h][e], neg ? -acc[h][e] : acc[h][e]);
      }
    }
}
__device__ __forceinline__ void fold_tail(int n_fold, int ft, bool neg, const float (&tail)[2][4],
                                          float (&hi)[2][4], float (&lo)[2][4]) {
  if (ft < n_fold) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) add_float(hi[h][e], lo[h][e], neg ? -tail[h][e] : tail[h][e]);
  }
}

// The level lists of a warp's 16 x 16 output tile (rows m0.., columns n0..;
// element e of half h at row m0 + lane/4 + 8 (e/2), column n0 + 8h + 2
// (lane % 4) + e % 2), formed level by level and each folded as it is
// formed (fold_level).  Level d sums over the chunk pairs i + j = d; each
// k16 step of a pair is one tensor-core product per half from a zeroed
// fragment (merged: the two of a list chained), gathered with float32 adds.
// MERGED (chunks xa = re, xb = im, one row scale): list 0 = xa.mre -
// xb.mim (the slice -im: a sign flip of both bf16 halves of the B
// registers, exact) into (hi0, lo0) and, with BOTH, list 1 = xa.mim +
// xb.mre into (hi1, lo1), the two from the same A fragments.  Else list 0
// = xa . slice component ma, folded with `neg`.
template <bool MERGED, bool BOTH>
__device__ __forceinline__ void level_lists(const uint16_t* xa, const uint16_t* xb, int ma,
                                            bool neg, const uint16_t* s_m, int ms, int ls,
                                            int cs, int ks, int kp, int sx, int nsl, int m0,
                                            int n0, int lane, int n_fold, int ft,
                                            float (&hi0)[2][4], float (&lo0)[2][4],
                                            float (&hi1)[2][4], float (&lo1)[2][4]) {
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float tail0[2][4] = {}, tail1[2][4] = {};
#pragma unroll 1
  for (int d = 0; d < n_fold; ++d) {
    float acc0[2][4] = {}, acc1[2][4] = {};
    const int i0 = d - nsl + 1 > 0 ? d - nsl + 1 : 0, i1 = d < sx - 1 ? d : sx - 1;
#pragma unroll 1
    for (int i = i0; i <= i1; ++i) {
      const int j = d - i;  // < nsl
      const uint16_t* pa = xa + (size_t)i * cs + m0 * ks;
      const uint16_t* pb = xb + (size_t)i * cs + m0 * ks;
      const uint16_t* qr = s_m + (size_t)(2 * j + (MERGED ? 0 : ma)) * ms + n0;
      const uint16_t* qi = s_m + (size_t)(2 * j + 1) * ms + n0;
#pragma unroll 2
      for (int kb = 0; kb < kp; kb += 16) {
        unsigned a[4], a2[4];
        load_a(pa + kb, ks, lane, a);
        if (MERGED) load_a(pb + kb, ks, lane, a2);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          unsigned br[2], bi[2];
          float p[4];
          load_b(qr + kb * ls + 8 * h, ls, lane, br);
          mma_bf16(p, a, br, zero);
          if (MERGED) {
            load_b(qi + kb * ls + 8 * h, ls, lane, bi);
            const unsigned bn[2] = {bi[0] ^ 0x80008000u, bi[1] ^ 0x80008000u};
            mma_bf16(p, a2, bn, p);
            if (BOTH) {
              float q[4];
              mma_bf16(q, a, bi, zero);
              mma_bf16(q, a2, br, q);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc1[h][e] += q[e];
            }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc0[h][e] += p[e];
        }
      }
    }
    fold_level(d, ft, MERGED ? false : neg, acc0, tail0, hi0, lo0);
    if (BOTH) fold_level(d, ft, false, acc1, tail1, hi1, lo1);
  }
  fold_tail(n_fold, ft, MERGED ? false : neg, tail0, hi0, lo0);
  if (BOTH) fold_tail(n_fold, ft, false, tail1, hi1, lo1);
}

// ---- the tile --------------------------------------------------------------

// Every thread of the block takes part (loads, barriers).  The column
// group's slices are in shared memory already (load_slices).  Steps:
// 1. the tile's chunks into shared memory as bf16, zero-padded to 16-row
//    strips and to K16 (presliced: copied; else cut from the row maxima);
// 2. per 16 x 16 output tile, each warp in turn, with no barrier: the lists
//    of each output (merged: re = cr.mre - ci.mim and im = cr.mim + ci.mre
//    together; unmerged: rr, then ii into re, ri, then ir into im), formed
//    and folded level by level (level_lists), and the store.
__device__ __forceinline__ void oz_tile(const OzTile& t, float* smem) {
  const int K = t.K, sx = t.sx, TR = t.tr_rows, nsl = t.nsl;
  const int Kp = padded_k(K), KS = k_stride(K), lp = padded_l(t.lg), LS = l_stride(t.lg);
  const bool cplx_in = (t.ih != nullptr) || (t.pre1 != nullptr) || (t.pre0 != nullptr && t.merged);
  const bool cplx_out = t.oih != nullptr;
  const int ms = Kp * LS, cs = TR * KS;                 // a slice component; a chunk plane
  const uint16_t* s_m = reinterpret_cast<const uint16_t*>(smem);  // [nsl][re, im][Kp][LS]
  uint16_t* s_cr = reinterpret_cast<uint16_t*>(smem) + 2 * (size_t)nsl * ms;  // [sx][TR][KS]
  uint16_t* s_ci = s_cr + (size_t)sx * cs;              // [sx][TR][KS]
  unsigned* s_max = reinterpret_cast<unsigned*>(s_ci + (size_t)sx * cs);  // [2][TR]
  const int nt = blockDim.x, tid = threadIdx.x;
  const int n_el = TR * Kp;

  // 1. the tile's chunks
  __syncthreads();  // the previous tile is done with the chunks
  if (t.pre0 != nullptr) {
    // row r, chunk i: K values at pre0 (+ K for the imaginary half, merged)
    const long long pw = (long long)sx * K * (t.merged ? 2 : 1);  // a presliced row
    const bool vec = (K % 8 == 0) && ((reinterpret_cast<uintptr_t>(t.pre0) & 15) == 0)
                     && (t.pre1 == nullptr || (reinterpret_cast<uintptr_t>(t.pre1) & 15) == 0);
    const int g = vec ? Kp / 8 : Kp, gk = vec ? K / 8 : K, width = vec ? 8 : 1;
    for (int idx = tid; idx < sx * TR * g; idx += nt) {
      const int c = idx % g, r = (idx / g) % TR, i = idx / (g * TR);
      uint16_t* dr = s_cr + (size_t)i * cs + (size_t)r * KS + width * c;
      uint16_t* di = s_ci + (size_t)i * cs + (size_t)r * KS + width * c;
      const bool in = r < t.nrows && c < gk;
      const long long off = in ? in_row(t, r) * pw + (long long)i * K * (t.merged ? 2 : 1) + width * c : 0;
      const uint16_t* pr = t.pre0 + off;
      const uint16_t* pi = t.merged ? pr + K : t.pre1 + off;
      if (vec) {
        const uint4 z = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(dr) = in ? *reinterpret_cast<const uint4*>(pr) : z;
        *reinterpret_cast<uint4*>(di) = in ? *reinterpret_cast<const uint4*>(pi) : z;
      } else {
        *dr = in ? *pr : (uint16_t)0;
        *di = in ? *pi : (uint16_t)0;
      }
    }
  } else {
    for (int r = tid; r < 2 * TR; r += nt) s_max[r] = 0u;
    __syncthreads();
    // phased mode forms phase * x here and again below: the same
    // operations on the same inputs, so the same bits (nothing is staged)
    for (int idx = tid; idx < t.nrows * K; idx += nt) {
      const int r = idx / K, k = idx % K;
      const long long off = in_row(t, r) * K + k;
      if (cplx_in) {
        float xrh, xrl, xih, xil;
        operand(t, off, k, xrh, xrl, xih, xil);
        atomicMax(&s_max[r], __float_as_uint(fabsf(xrh)));
        atomicMax(&s_max[t.merged ? r : TR + r], __float_as_uint(fabsf(xih)));
      } else {
        atomicMax(&s_max[r], __float_as_uint(fabsf(t.rh[off])));
      }
    }
    __syncthreads();
    for (int idx = tid; idx < n_el; idx += nt) {
      const int r = idx / Kp, k = idx % Kp;
      uint16_t* pr = s_cr + (size_t)r * KS + k;
      uint16_t* pi = s_ci + (size_t)r * KS + k;
      if (r < t.nrows && k < K) {
        const long long off = in_row(t, r) * K + k;
        const float sr = pow2_ceil_bits(s_max[r]);
        if (cplx_in) {
          float xrh, xrl, xih, xil;
          operand(t, off, k, xrh, xrl, xih, xil);
          extract_chunks(xrh, xrl, sr, t.w, sx, pr, cs);
          const float si = t.merged ? sr : pow2_ceil_bits(s_max[TR + r]);
          extract_chunks(xih, xil, si, t.w, sx, pi, cs);
        } else {
          extract_chunks(t.rh[off], t.rl[off], sr, t.w, sx, pr, cs);
          for (int i = 0; i < sx; ++i) pi[i * cs] = 0;
        }
      } else {
        for (int i = 0; i < sx; ++i) pr[i * cs] = pi[i * cs] = 0;
      }
    }
  }
  __syncthreads();

  // 2. each warp's output tiles in turn
  const int lane = tid & 31, warp = tid >> 5;
  const int n_nt = lp / 16, n_wt = (TR / 16) * n_nt;
  const int n_fold = min(t.nlev, sx + t.sm - 1);
  const int ft = t.fold_tail < 0 ? n_fold : max(1, min(t.fold_tail, n_fold));
  for (int wt = warp; wt < n_wt; wt += OZ_WARPS) {
    const int m0 = (wt / n_nt) * 16, n0 = (wt % n_nt) * 16;
    float hr[2][4] = {}, lr[2][4] = {}, hm[2][4] = {}, lm[2][4] = {};  // re, im
#define OZ_LISTS(MERGED, BOTH, XA, XB, MA, NEG, H0, L0, H1, L1)                                 \
  level_lists<MERGED, BOTH>(XA, XB, MA, NEG, s_m, ms, LS, cs, KS, Kp, sx, nsl, m0, n0, lane, \
                            n_fold, ft, H0, L0, H1, L1)
    if (t.merged) {
      if (cplx_out) OZ_LISTS(true, true, s_cr, s_ci, 0, false, hr, lr, hm, lm);
      else OZ_LISTS(true, false, s_cr, s_ci, 0, false, hr, lr, hm, lm);
    } else {
      OZ_LISTS(false, false, s_cr, s_cr, 0, false, hr, lr, hm, lm);                // rr
      if (cplx_in) OZ_LISTS(false, false, s_ci, s_ci, 1, true, hr, lr, hm, lm);    // -ii
      if (cplx_out) {
        OZ_LISTS(false, false, s_cr, s_cr, 1, false, hm, lm, hr, lr);              // ri
        if (cplx_in) OZ_LISTS(false, false, s_ci, s_ci, 0, false, hm, lm, hr, lr);  // ir
      }
    }
#undef OZ_LISTS
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = m0 + (lane >> 2) + 8 * (e >> 1);
        const int l = n0 + 8 * h + 2 * (lane & 3) + (e & 1);
        if (rr < t.nrows && l < t.lg) {
          const long long r = t.row0 + rr;
          const long long o = (r / t.B) * t.sa + (r % t.B) * t.sb + (long long)(t.c0 + l) * t.sl;
          t.orh[o] = hr[h][e];
          t.orl[o] = lr[h][e];
          if (cplx_out) {
            t.oih[o] = hm[h][e];
            t.oil[o] = lm[h][e];
          }
        }
      }
  }
}

// The row tiles tile0, tile0 + dtile, ... of a stage of `rows` rows against
// one node's slices, for the column groups group0, group0 + dgroup, ...,
// with `extra` bytes of shared memory in use beside `smem` (the plan is the
// one the launch sized the shared memory by).  The slices of a column group
// are loaded once and serve all of its tiles.
__device__ __forceinline__ void oz_stage(OzTile t, int rows, int tile0, int dtile, int group0, int dgroup,
                         float* smem, size_t extra) {
  const OzPlan p = oz_plan(t.K, t.L, t.sx, t.nsl, rows, extra);
  t.tr_rows = p.tr;
  const int n_tiles = (rows + p.tr - 1) / p.tr;
  for (int c0 = group0 * p.lg; c0 < t.L; c0 += dgroup * p.lg) {
    t.c0 = c0;
    t.lg = min(p.lg, t.L - c0);
    load_slices(t, smem);
    for (int tile = tile0; tile < n_tiles; tile += dtile) {
      t.row0 = tile * p.tr;
      t.nrows = min(p.tr, rows - t.row0);
      oz_tile(t, smem);
    }
  }
}

}  // namespace bfft_oz
