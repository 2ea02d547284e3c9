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
// versions.  The exact chunk dots use fmaf() explicitly: each product of two
// bf16 values is exact in float32, so the fused and the unfused forms agree.
//
// The numbers of boltzfft_torch/oz.py: chunk width w (7), at most 7 chunks
// of an operand (sx = min(7, cmax + 1)), at most 8 matrix slices (sm), and
// NLEV = cmax + 1 <= 8 levels.
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

// The sx chunks of hi + lo at scale sig (oz.chunk_rows): the shift trick
// with the mid-binade constant 1.5 * 2^(23 - w(i+1)) * sig, whose ulp is the
// chunk unit, then the low word folded into the residual.
__device__ __forceinline__ void extract_chunks(float hi, float lo, float sig, int w, int sx,
                                               float* out, int stride) {
  for (int i = 0; i < sx; ++i) {
    const float mi = ldexpf(1.5f, 23 - w * (i + 1)) * sig;  // exact
    const float c = (hi + mi) - mi;
    out[i * stride] = c;
    hi = hi - c;  // exact
    two_sum(hi, lo, hi, lo);
  }
}

__device__ __forceinline__ float bf16_to_float(uint16_t u) {
  return __uint_as_float(((unsigned)u) << 16);
}

// Chunks hold at most 8 significant bits, so dropping the low half is exact.
__device__ __forceinline__ uint16_t float_to_bf16_exact(float x) {
  return (uint16_t)(__float_as_uint(x) >> 16);
}

// ---- one tile of the sliced contraction --------------------------------

// A tile of `nrows` consecutive rows (from `row0`) of one contraction stage
// against one node's matrix slices.  Inputs: float32 planes at row stride K
// (ih == nullptr: a real input), or presliced bf16 chunks (pre0/pre1:
// unmerged, sx*K per row each; pre0 alone: merged, sx*2K per row).  Row r
// of the stage reads input row (r / iB) * isa + (r % iB) * isb (the
// identity by default).  Phased mode (prh != nullptr, complex planes in,
// unmerged): the operand is t = phase * x (conj(phase) when `conj`), the
// phase a ds row of K values (prh, prl, pih, pil) shared by the tile's rows.
// Output (oih == nullptr: real output only) of row r and column l at
// (r / B) * sa + (r % B) * sb + l * sl.
struct OzTile {
  const float *rh, *rl, *ih, *il;
  const uint16_t *pre0, *pre1;
  const uint16_t *mre, *mim;  // (sm, K, L)
  float *orh, *orl, *oih, *oil;
  int row0, nrows, tr_rows;   // tile start, rows in it, rows a tile holds
  int K, L, sm, sx, w, fold_tail, merged;
  long long B, sa, sb, sl;
  long long iB = 1, isa = 1, isb = 0;
  const float *prh = nullptr, *prl = nullptr, *pih = nullptr, *pil = nullptr;
  int conj = 0;
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

// Shared memory of a tile: chunks 2 * sx * tr_rows * Kp floats, matrix slice
// 2 * L * mat_stride floats, row maxima 2 * tr_rows words.
__host__ __device__ inline int padded_k(int K) { return (K + 3) & ~3; }
__host__ __device__ inline int mat_stride(int K) {
  const int kp = padded_k(K);
  return ((kp / 4) % 2) ? kp : kp + 4;  // odd 16-byte stride: conflict-free float4 rows
}
__host__ __device__ inline size_t tile_smem_bytes(int K, int L, int sx, int tr_rows) {
  return sizeof(float) * (2 * (size_t)sx * tr_rows * padded_k(K) + 2 * (size_t)L * mat_stride(K))
         + 2 * sizeof(unsigned) * tr_rows;
}

template <int NLEV>
__device__ __forceinline__ void fold_levels(const float (&lv)[NLEV], bool neg, int n_fold,
                                            int ft, float& hi, float& lo) {
  float tail = 0.0f;
  bool has_tail = false;
#pragma unroll
  for (int d = 0; d < NLEV; ++d) {
    if (d < n_fold) {
      const float v = lv[d];
      if (d >= ft) {
        tail = has_tail ? tail + v : v;
        has_tail = true;
      } else {
        add_float(hi, lo, neg ? -v : v);
      }
    }
  }
  if (has_tail) add_float(hi, lo, neg ? -tail : tail);
}

// Every thread of the block takes part (loads, barriers); threads below
// tr_rows * L compute one output each.
template <int NLEV>
__device__ __noinline__ void oz_tile(const OzTile t, float* smem) {
  const int K = t.K, L = t.L, sx = t.sx, TR = t.tr_rows;
  const int Kp = padded_k(K), S = mat_stride(K);
  const bool cplx_in = (t.ih != nullptr) || (t.pre1 != nullptr) || (t.pre0 != nullptr && t.merged);
  const bool cplx_out = t.oih != nullptr;
  float* s_cr = smem;                        // [sx][TR][Kp]
  float* s_ci = s_cr + (size_t)sx * TR * Kp;  // [sx][TR][Kp]
  float* s_mr = s_ci + (size_t)sx * TR * Kp;  // [L][S]
  float* s_mi = s_mr + (size_t)L * S;         // [L][S]
  unsigned* s_max = reinterpret_cast<unsigned*>(s_mi + (size_t)L * S);  // [2][TR]
  const int nt = blockDim.x, tid = threadIdx.x;
  const int n_el = TR * Kp;

  // 1. the tile's chunks
  __syncthreads();  // the previous tile is done with the shared buffers
  if (t.pre0 != nullptr) {
    for (int idx = tid; idx < sx * n_el; idx += nt) {
      const int i = idx / n_el, r = (idx / Kp) % TR, k = idx % Kp;
      float cr = 0.0f, ci = 0.0f;
      if (r < t.nrows && k < K) {
        const long long row = in_row(t, r);
        if (t.merged) {
          const uint16_t* p = t.pre0 + row * (2LL * sx * K) + (long long)i * 2 * K;
          cr = bf16_to_float(p[k]);
          ci = bf16_to_float(p[K + k]);
        } else {
          cr = bf16_to_float(t.pre0[row * ((long long)sx * K) + (long long)i * K + k]);
          ci = bf16_to_float(t.pre1[row * ((long long)sx * K) + (long long)i * K + k]);
        }
      }
      s_cr[idx] = cr;
      s_ci[idx] = ci;
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
      if (r < t.nrows && k < K) {
        const long long off = in_row(t, r) * K + k;
        const float sr = pow2_ceil_bits(s_max[r]);
        if (cplx_in) {
          float xrh, xrl, xih, xil;
          operand(t, off, k, xrh, xrl, xih, xil);
          extract_chunks(xrh, xrl, sr, t.w, sx, s_cr + idx, n_el);
          const float si = t.merged ? sr : pow2_ceil_bits(s_max[TR + r]);
          extract_chunks(xih, xil, si, t.w, sx, s_ci + idx, n_el);
        } else {
          extract_chunks(t.rh[off], t.rl[off], sr, t.w, sx, s_cr + idx, n_el);
          for (int i = 0; i < sx; ++i) s_ci[i * n_el + idx] = 0.0f;
        }
      } else {
        for (int i = 0; i < sx; ++i) s_cr[i * n_el + idx] = s_ci[i * n_el + idx] = 0.0f;
      }
    }
  }

  // 2. the exact level sums, one matrix slice j at a time
  const int tr = tid / L, l = tid % L;
  const bool active = tid < TR * L && tr < t.nrows;
  float lrr[NLEV], lii[NLEV], lri[NLEV], lir[NLEV];
#pragma unroll
  for (int d = 0; d < NLEV; ++d) lrr[d] = lii[d] = lri[d] = lir[d] = 0.0f;
#pragma unroll
  for (int j = 0; j < SM_MAX && j < NLEV; ++j) {
    if (j < t.sm) {
      __syncthreads();  // chunks ready / the previous slice is consumed
      const uint16_t* gr = t.mre + (size_t)j * K * L;
      const uint16_t* gi = t.mim + (size_t)j * K * L;
      for (int idx = tid; idx < L * Kp; idx += nt) {
        const int k = idx / L, ll = idx % L;
        const bool in = k < K;
        s_mr[ll * S + k] = in ? bf16_to_float(gr[k * L + ll]) : 0.0f;
        s_mi[ll * S + k] = in ? bf16_to_float(gi[k * L + ll]) : 0.0f;
      }
      __syncthreads();
      if (active) {
        const float4* mr4 = reinterpret_cast<const float4*>(s_mr + l * S);
        const float4* mi4 = reinterpret_cast<const float4*>(s_mi + l * S);
#pragma unroll
        for (int i = 0; i < SX_MAX; ++i) {
          if (i + j < NLEV && i < sx) {
            const float4* cr4 = reinterpret_cast<const float4*>(s_cr + ((size_t)i * TR + tr) * Kp);
            const float4* ci4 = reinterpret_cast<const float4*>(s_ci + ((size_t)i * TR + tr) * Kp);
            float arr = 0.0f, aii = 0.0f, ari = 0.0f, air = 0.0f;
            for (int k4 = 0; k4 < Kp / 4; ++k4) {
              const float4 xr = cr4[k4], xi = ci4[k4], mr = mr4[k4], mi = mi4[k4];
              arr = fmaf(xr.x, mr.x, arr); arr = fmaf(xr.y, mr.y, arr);
              arr = fmaf(xr.z, mr.z, arr); arr = fmaf(xr.w, mr.w, arr);
              if (cplx_in) {
                aii = fmaf(xi.x, mi.x, aii); aii = fmaf(xi.y, mi.y, aii);
                aii = fmaf(xi.z, mi.z, aii); aii = fmaf(xi.w, mi.w, aii);
              }
              if (cplx_out) {
                ari = fmaf(xr.x, mi.x, ari); ari = fmaf(xr.y, mi.y, ari);
                ari = fmaf(xr.z, mi.z, ari); ari = fmaf(xr.w, mi.w, ari);
                if (cplx_in) {
                  air = fmaf(xi.x, mr.x, air); air = fmaf(xi.y, mr.y, air);
                  air = fmaf(xi.z, mr.z, air); air = fmaf(xi.w, mr.w, air);
                }
              }
            }
            // partial level sums: exact (common unit, far below 2^24 of it)
            lrr[i + j] += arr;
            lii[i + j] += aii;
            lri[i + j] += ari;
            lir[i + j] += air;
          }
        }
      }
    }
  }

  // 3. the fold, in the TPU kernel's order, and the store
  if (!active) return;
  const int n_fold = min(NLEV, sx + t.sm - 1);
  const int ft = t.fold_tail < 0 ? n_fold : max(1, min(t.fold_tail, n_fold));
  float reh = 0.0f, rel = 0.0f, imh = 0.0f, iml = 0.0f;
  if (t.merged) {
    float lre[NLEV], lim[NLEV];
#pragma unroll
    for (int d = 0; d < NLEV; ++d) {
      lre[d] = lrr[d] - lii[d];  // exact under merge_ok
      lim[d] = lri[d] + lir[d];
    }
    fold_levels<NLEV>(lre, false, n_fold, ft, reh, rel);
    if (cplx_out) fold_levels<NLEV>(lim, false, n_fold, ft, imh, iml);
  } else {
    fold_levels<NLEV>(lrr, false, n_fold, ft, reh, rel);
    if (cplx_in) fold_levels<NLEV>(lii, true, n_fold, ft, reh, rel);
    if (cplx_out) {
      fold_levels<NLEV>(lri, false, n_fold, ft, imh, iml);
      if (cplx_in) fold_levels<NLEV>(lir, false, n_fold, ft, imh, iml);
    }
  }
  const long long r = t.row0 + tr;
  const long long o = (r / t.B) * t.sa + (r % t.B) * t.sb + (long long)l * t.sl;
  t.orh[o] = reh;
  t.orl[o] = rel;
  if (cplx_out) {
    t.oih[o] = imh;
    t.oil[o] = iml;
  }
}

}  // namespace bfft_oz
