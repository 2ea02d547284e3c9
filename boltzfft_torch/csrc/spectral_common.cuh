// Device code shared by the port's spectral kernels (fused_collide.cu: K1,
// K2 and K4; fused_gain_kron.cu: K3): complex helpers, the tensor-core
// units (DMMA, the 3xTF32 step), the axis transforms on the tensor cores
// and the ordered beta1 accumulation (K3).
//
// Every transform of K1, K2 and K4 is a dense complex matrix times a tile of
// lines, out = M diag(phase) X, the product the TPU kernels send to the MXU
// with jnp.dot (boltzfft/pallas_kernels.py:548-720).  Here it runs on the
// Hopper tensor cores as four real products of the re/im planes,
// Yr = Mr Xr - Mi Xi and Yi = Mr Xi + Mi Xr (not the 3-multiply form, which
// loses digits):
//  * double: mma.sync m8n8k4 f64 (DMMA, 67 TFLOP/s; Hopper has no f64
//    wgmma), accumulated in the fragment over the whole k loop;
//  * float: 3xTF32.  Each operand is split hi = tf32(a), lo = tf32(a - hi)
//    (round to nearest, ties away) and each product is lo*hi + hi*lo + hi*hi
//    (mma.sync m16n8k8 tf32).  The tensor core's adder truncates, and
//    chained over a k loop that bias missed the float32 tolerance on the
//    card, so each k8 step puts each hi*hi product into a zeroed fragment of
//    its own and chains only the small terms, and float adds (round to
//    nearest) gather them into the accumulator.  Single-pass TF32 keeps
//    about three digits and is never used, not even for
//    fused_precision="default".
// What bounds the transforms now: the tensor-core arithmetic, and the node
// streams' bytes that are left (one write and one read of every stream, two
// on the route for large planes).  What the design does about it:
//  * The matrix goes into shared memory once per block (zero-padded to a
//    multiple of 16, pre-split for float) and the block walks many tiles
//    in a persistent loop; tiles are double-buffered with cp.async where
//    shared memory allows, so loads overlap the products.  Along an axis
//    whose matrix and tile do not fit together (over 96 points), the line
//    kernel reads its A fragments from the matrix in device memory instead
//    (L2-resident; split per fragment in float, the same bits), with the
//    same k loop and so the same result.
//  * The node phase costs no pass of its own on the plane route: az is
//    folded into the z pass's B fragments, ax ay into its output (diagonal,
//    they commute with the z transform).  A line pass that takes a phase
//    (the last-pass route, K3's x leg) folds it into its tile once.
//  * plane_dft_kernel runs the y and z axes of a block of x planes in shared
//    memory (one launch, the streams written once); line_dft_kernel runs one
//    axis with an epilogue: a plain store, the Hadamard product and group sum
//    of both streams of a node (kGain: only the group sum is written), or the
//    beta1 sum over groups (kBeta1: into the gain spectrum).
//  * k1_plan below is the one count of their shared memory
//    (kernels.fused_collide.plan mirrors it): the plane route where a plane
//    block fits, else y and z as line passes (the last-pass route), and
//    which axis fits no tile at all.
// Every output's accumulation order is fixed by the tile's k loop and the
// node and group loops, never by the grid, the batch or the node chunk, and
// no reduction uses float atomics: results are bitwise reproducible, a batch
// is bitwise equal to per-item calls, and a chunked call to one chunk.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace bfft {

constexpr int kThreads = 256;  // threads of the element-wise kernels

template <typename T> struct Cplx;
template <> struct Cplx<float> { using type = float2; };
template <> struct Cplx<double> { using type = double2; };

__device__ __forceinline__ float dev_sin(float x) { return sinf(x); }
__device__ __forceinline__ double dev_sin(double x) { return sin(x); }

template <typename C2>
__device__ __forceinline__ C2 cmul(C2 a, C2 b) {
  C2 r;
  r.x = a.x * b.x - a.y * b.y;
  r.y = a.x * b.y + a.y * b.x;
  return r;
}

// ---------------------------------------------------------------------------
// The shared-memory plan (the one count; kernels.fused_collide mirrors it)
// ---------------------------------------------------------------------------

constexpr int kPad = 16;            // every transformed axis is padded to this
constexpr int kTcWarps = 8;         // most warps of a line-kernel block
constexpr int kPlaneWarps = 16;     // most warps of a plane-kernel block
constexpr int kSmemLimit = 232448;  // shared memory an H100 block may use
constexpr int kPlaneElems = 2048;   // most padded points of a plane block
constexpr int kMatPad = 4;          // matrix row padding (conflict-free A loads)
constexpr int kRawPad = 4;          // plane row padding (z-pass B loads)
constexpr int kLinePad32 = 8;       // float tile row padding (B loads)

__host__ __device__ inline int pad16(int n) { return (n + kPad - 1) / kPad * kPad; }

// One (n, n) matrix, padded, 16 bytes a point: re, im planes of double, or
// re hi, re lo, im hi, im lo planes of float (tf32 bits).
__host__ __device__ inline long long mat_bytes(int n) {
  return (long long)pad16(n) * (pad16(n) + kMatPad) * 16;
}

struct LinePlan {
  int lines;      // lines per tile (0: no tile fits)
  int nbuf;       // tile buffers (2: double-buffered by cp.async)
  bool resident;  // the matrix in shared memory (else read from device memory)
  long long smem;
};

// A line-kernel block along an axis of n points: the matrix if resident,
// nbuf x S complex tiles (n_pad x lines), and an n_pad x lines accumulator
// of acc_bytes a point (0 for the plain store, the real for kGain, the
// complex for kBeta1).  csize: 8 (float) or 16 (double).
__host__ __device__ inline long long line_smem(int n, int streams, int acc_bytes,
                                               int csize, int lines, int nbuf,
                                               bool resident) {
  const int ld = lines + (csize == 8 ? kLinePad32 : 0);
  return (resident ? mat_bytes(n) : 0) +
         (long long)nbuf * streams * pad16(n) * ld * csize +
         (long long)pad16(n) * lines * acc_bytes;
}

// The first tile that fits, with the matrix resident, else without it.
__host__ __device__ inline LinePlan line_plan(int n, int streams, int acc_bytes,
                                              int csize) {
  const int cand[3][2] = {{32, 2}, {16, 2}, {16, 1}};
  for (int r = 1; r >= 0; --r)
    for (int c = 0; c < 3; ++c) {
      const long long b =
          line_smem(n, streams, acc_bytes, csize, cand[c][0], cand[c][1], r == 1);
      if (b <= kSmemLimit) return LinePlan{cand[c][0], cand[c][1], r == 1, b};
    }
  return LinePlan{0, 1, false, line_smem(n, streams, acc_bytes, csize, 16, 1, false)};
}

// A plane-kernel block: the z matrix (and the y matrix unless ny == nz: the
// DFT matrices depend only on the length), then `planes` x planes of the
// input (rows of nz_pad + kRawPad) and of the z pass's output, then room for
// a unit's phase rows.
__host__ __device__ inline long long plane_smem(int nx, int ny, int nz, int csize, int planes) {
  const long long mats = mat_bytes(nz) + (ny == nz ? 0 : mat_bytes(ny));
  const int ld_raw = pad16(nz) + kRawPad;
  const int ld_mid = pad16(nz) + (csize == 8 ? kLinePad32 : 0);
  return mats + (long long)planes * pad16(ny) * (ld_raw + ld_mid) * csize +
         (long long)(nx + ny + pad16(nz)) * csize;
}

// x planes per plane-kernel block: the largest divisor of nx whose block
// holds at most kPlaneElems padded points and fits; 0 when one plane does
// not fit (then y and z run as line passes).
__host__ __device__ inline int plane_count(int nx, int ny, int nz, int csize) {
  int best = 0;
  for (int p = 1; p <= nx; ++p) {
    if (nx % p) continue;
    if (p > 1 && (long long)p * pad16(ny) * pad16(nz) > kPlaneElems) break;
    if (plane_smem(nx, ny, nz, csize, p) > kSmemLimit) break;
    best = p;
  }
  return best;
}

// Record axis as the first that fits no tile (out[1], out[2]).
__host__ __device__ inline void plan_fit(int axis, const LinePlan& lp, int* out) {
  if (lp.lines == 0 && out[1] < 0) {
    out[1] = axis;
    out[2] = (int)lp.smem;
  }
}

// K1's plan for a grid: out[0] the route (1 plane, 2 last pass, 0 none),
// out[1] the first axis that fits no tile (-1: none), out[2] the bytes its
// smallest tile needs.  x runs the gain, beta1 and store passes; y and z run
// store passes where a plane does not fit.
__host__ __device__ inline void k1_plan(int nx, int ny, int nz, int csize, int* out) {
  out[0] = 0;
  out[1] = -1;
  out[2] = 0;
  plan_fit(0, line_plan(nx, 2, csize / 2, csize), out);
  plan_fit(0, line_plan(nx, 1, csize, csize), out);
  plan_fit(0, line_plan(nx, 1, 0, csize), out);
  const bool planes = plane_count(nx, ny, nz, csize) > 0;
  if (!planes) {
    plan_fit(1, line_plan(ny, 1, 0, csize), out);
    plan_fit(2, line_plan(nz, 1, 0, csize), out);
  }
  out[0] = out[1] >= 0 ? 0 : (planes ? 1 : 2);
}

// ---------------------------------------------------------------------------
// Tensor-core fragments
// ---------------------------------------------------------------------------

// A warp owns 16 x 16 output tiles: 2 x 2 DMMA tiles (8 x 8) in double, 1 x 2
// tf32 tiles (16 x 8) in float.  kAcc: accumulator values per thread and
// tile, at rows (lane / 4) + 8 (r / 2), columns 2 (lane % 4) + r % 2.
template <typename T> struct Tc;
template <> struct Tc<double> {
  static constexpr int kM = 8, kN = 8, kK = 4, kWM = 2, kWN = 2, kAcc = 2;
};
template <> struct Tc<float> {
  static constexpr int kM = 16, kN = 8, kK = 8, kWM = 1, kWN = 2, kAcc = 4;
};

__device__ __forceinline__ void mma_dmma(double (&d)[2], double a, double b) {
  asm(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// The m16n8k8 shape of DMMA (sm_90): fragments laid out as mma_tf32's.
__device__ __forceinline__ void mma_dmma16(double (&d)[4], const double (&a)[4],
                                           const double (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b into a fresh fragment (the C operand zero)
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// a = hi + lo + O(2^-22 |a|), both tf32
__device__ __forceinline__ void tf32_split(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

// One m16n8k8 step of a complex product by 3xTF32: re += Ar Br - Ai Bi,
// im += Ar Bi + Ai Br, every operand split hi/lo (tf32 bits; nai* = -ai*).
// The tensor core's adder truncates: each hi*hi product goes into a zeroed
// fragment of its own, the four small ones (2^-11 of it) are chained into a
// third, and float adds gather them.
__device__ __forceinline__ void tf32_cmac(
    float (&re)[4], float (&im)[4], const uint32_t (&arh)[4], const uint32_t (&arl)[4],
    const uint32_t (&aih)[4], const uint32_t (&ail)[4], const uint32_t (&naih)[4],
    const uint32_t (&nail)[4], const uint32_t (&brh)[2], const uint32_t (&brl)[2],
    const uint32_t (&bih)[2], const uint32_t (&bil)[2]) {
  float r1[4], r2[4], rs[4], i1[4], i2[4], is[4];
  mma_tf32_zero(rs, arl, brh);
  mma_tf32(rs, arh, brl);
  mma_tf32(rs, nail, bih);
  mma_tf32(rs, naih, bil);
  mma_tf32_zero(r1, arh, brh);
  mma_tf32_zero(r2, naih, bih);
  mma_tf32_zero(is, arl, bih);
  mma_tf32(is, arh, bil);
  mma_tf32(is, ail, brh);
  mma_tf32(is, aih, brl);
  mma_tf32_zero(i1, arh, bih);
  mma_tf32_zero(i2, aih, brh);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    re[r] = ((re[r] + r1[r]) + r2[r]) + rs[r];
    im[r] = ((im[r] + i1[r]) + i2[r]) + is[r];
  }
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? kBytes : 0;  // 0: fill with zeros, read nothing
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src),
               "n"(kBytes), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Stage the (n, n) complex matrix into shared memory, zero-padded to
// pad16(n) x (pad16(n) + kMatPad): double re/im planes, or float hi/lo
// splits of re and im (tf32 bits).
template <typename T>
__device__ void stage_matrix(unsigned char* sm, const typename Cplx<T>::type* mat, int n) {
  using C2 = typename Cplx<T>::type;
  const int np = pad16(n), ld = np + kMatPad;
  const int plane = np * ld;
  for (int e = threadIdx.x; e < plane; e += blockDim.x) {
    const int i = e / ld, k = e % ld;
    C2 v;
    v.x = 0;
    v.y = 0;
    if (i < n && k < n) v = mat[i * n + k];
    if constexpr (sizeof(T) == 8) {
      double* p = reinterpret_cast<double*>(sm);
      p[e] = v.x;
      p[plane + e] = v.y;
    } else {
      uint32_t* p = reinterpret_cast<uint32_t*>(sm);
      tf32_split(v.x, p[e], p[plane + e]);
      tf32_split(v.y, p[2 * plane + e], p[3 * plane + e]);
    }
  }
}

// The accumulators of a warp's 16 x 16 tile for S streams.
template <typename T, int S>
struct TileAcc {
  T re[S][Tc<T>::kWM][Tc<T>::kWN][Tc<T>::kAcc];
  T im[S][Tc<T>::kWM][Tc<T>::kWN][Tc<T>::kAcc];
};

// A B operand element, complex or real (imaginary part 0).
template <typename T>
__device__ __forceinline__ typename Cplx<T>::type to_cplx(typename Cplx<T>::type x) {
  return x;
}
template <typename T>
__device__ __forceinline__ typename Cplx<T>::type to_cplx(T x) {
  typename Cplx<T>::type v;
  v.x = x;
  v.y = 0;
  return v;
}

// acc[s] = M B_s for the warp's tile at rows i0, columns n0, where M is the
// (n_mat, n_mat) matrix and B_s[k, n] = kph[k] bcol(s, n)[k * sk] (complex or
// real; kph, a phase along k in shared memory padded with zeros to
// pad16(n_mat), is optional).  a_src is the matrix staged by stage_matrix in
// shared memory, or (kGlobalA) the (n_mat, n_mat) complex matrix in device
// memory, read per fragment (zero outside it, split in float exactly as
// stage_matrix splits it, so both give the same bits).  The k loop runs in
// order; the fragments of step k + 1 are read while step k multiplies.
template <typename T, int S> struct Frags;
template <int S> struct Frags<double, S> {
  double ar[Tc<double>::kWM], ai[Tc<double>::kWM];
  double2 b[S][Tc<double>::kWN];
};
template <int S> struct Frags<float, S> {
  uint32_t arh[4], arl[4], aih[4], ail[4];
  float2 b[S][Tc<float>::kWN][2];
};

// Element (i, k) of the (n, n) complex matrix m in device memory, 0 outside.
template <typename C2>
__device__ __forceinline__ C2 mat_at(const C2* m, int n, int i, int k) {
  C2 v;
  v.x = 0;
  v.y = 0;
  if (i < n && k < n) v = __ldg(m + (long long)i * n + k);
  return v;
}

template <typename T, int S, typename In, bool kGlobalA>
__device__ __forceinline__ void load_frags(const void* a_src, int n_mat, int plane,
                                           int a_row, int ld, int k0,
                                           const In* (&bp)[S][Tc<T>::kWN], int sk,
                                           const typename Cplx<T>::type* kph,
                                           Frags<T, S>& f) {
  using TC = Tc<T>;
  using C2 = typename Cplx<T>::type;
  const int t = threadIdx.x & 3;
  const C2* gm = static_cast<const C2*>(a_src);
  if constexpr (sizeof(T) == 8) {
    const double* mr = static_cast<const double*>(a_src) + a_row * ld + t + k0;
#pragma unroll
    for (int a = 0; a < TC::kWM; ++a) {
      if constexpr (kGlobalA) {
        const C2 v = mat_at(gm, n_mat, a_row + a * TC::kM, k0 + t);
        f.ar[a] = v.x;
        f.ai[a] = v.y;
      } else {
        f.ar[a] = mr[a * TC::kM * ld];
        f.ai[a] = mr[plane + a * TC::kM * ld];
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int b = 0; b < TC::kWN; ++b) {
        C2 v = to_cplx<T>(bp[s][b][k0 * sk]);
        if (kph != nullptr) v = cmul(kph[k0 + t], v);
        f.b[s][b] = v;
      }
  } else {
    const uint32_t* mp = static_cast<const uint32_t*>(a_src) + a_row * ld + t + k0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if constexpr (kGlobalA) {
        const C2 v = mat_at(gm, n_mat, a_row + (q & 1) * 8, k0 + t + (q >> 1) * 4);
        tf32_split(v.x, f.arh[q], f.arl[q]);
        tf32_split(v.y, f.aih[q], f.ail[q]);
      } else {
        const int off = (q & 1) * 8 * ld + (q >> 1) * 4;
        f.arh[q] = mp[off];
        f.arl[q] = mp[plane + off];
        f.aih[q] = mp[2 * plane + off];
        f.ail[q] = mp[3 * plane + off];
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int b = 0; b < TC::kWN; ++b)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          C2 v = to_cplx<T>(bp[s][b][(k0 + 4 * q) * sk]);
          if (kph != nullptr) v = cmul(kph[k0 + t + 4 * q], v);
          f.b[s][b][q] = v;
        }
  }
}

template <typename T, int S>
__device__ __forceinline__ void mma_frags(const Frags<T, S>& f, TileAcc<T, S>& acc) {
  using TC = Tc<T>;
  if constexpr (sizeof(T) == 8) {
    // Mr X first on every tile, then Mi X: the two products of one
    // accumulator are never issued back to back
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int b = 0; b < TC::kWN; ++b)
#pragma unroll
        for (int a = 0; a < TC::kWM; ++a) {
          mma_dmma(acc.re[s][a][b], f.ar[a], f.b[s][b].x);
          mma_dmma(acc.im[s][a][b], f.ar[a], f.b[s][b].y);
        }
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int b = 0; b < TC::kWN; ++b)
#pragma unroll
        for (int a = 0; a < TC::kWM; ++a) {
          mma_dmma(acc.re[s][a][b], -f.ai[a], f.b[s][b].y);
          mma_dmma(acc.im[s][a][b], f.ai[a], f.b[s][b].x);
        }
  } else {
    uint32_t naih[4], nail[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      naih[q] = f.aih[q] ^ 0x80000000u;
      nail[q] = f.ail[q] ^ 0x80000000u;
    }
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int b = 0; b < TC::kWN; ++b) {
        uint32_t brh[2], brl[2], bih[2], bil[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          tf32_split(f.b[s][b][q].x, brh[q], brl[q]);
          tf32_split(f.b[s][b][q].y, bih[q], bil[q]);
        }
        tf32_cmac(acc.re[s][0][b], acc.im[s][0][b], f.arh, f.arl, f.aih, f.ail, naih, nail,
                  brh, brl, bih, bil);
      }
  }
}

template <typename T, int S, typename In, bool kGlobalA = false, class BCol>
__device__ __forceinline__ void tile_product(const void* a_src, int n_mat, int i0,
                                             int n0, BCol bcol, int sk,
                                             TileAcc<T, S>& acc,
                                             const typename Cplx<T>::type* kph = nullptr) {
  using TC = Tc<T>;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int np = pad16(n_mat), ld = np + kMatPad, plane = np * ld;
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int a = 0; a < TC::kWM; ++a)
#pragma unroll
      for (int b = 0; b < TC::kWN; ++b)
#pragma unroll
        for (int r = 0; r < TC::kAcc; ++r) acc.re[s][a][b][r] = acc.im[s][a][b][r] = 0;
  // this lane's A row and B columns, fixed over the k loop
  const int a_row = i0 + g;
  const In* bp[S][TC::kWN];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int b = 0; b < TC::kWN; ++b) bp[s][b] = bcol(s, n0 + b * TC::kN + g) + t * sk;
  // np is a multiple of 16, so of 2 kK: the steps go in pairs
  Frags<T, S> f0, f1;
  load_frags<T, S, In, kGlobalA>(a_src, n_mat, plane, a_row, ld, 0, bp, sk, kph, f0);
#pragma unroll 1
  for (int k0 = 0; k0 < np; k0 += 2 * TC::kK) {
    load_frags<T, S, In, kGlobalA>(a_src, n_mat, plane, a_row, ld, k0 + TC::kK, bp, sk,
                                   kph, f1);
    mma_frags<T, S>(f0, acc);
    if (k0 + 2 * TC::kK < np)
      load_frags<T, S, In, kGlobalA>(a_src, n_mat, plane, a_row, ld, k0 + 2 * TC::kK, bp,
                                     sk, kph, f0);
    mma_frags<T, S>(f1, acc);
  }
}

// Row and column, inside the warp's 16 x 16 tile, of accumulator r of mma
// tile (a, b).
template <typename T>
__device__ __forceinline__ int acc_row(int a, int r) {
  return a * Tc<T>::kM + ((threadIdx.x & 31) >> 2) + (r >> 1) * 8;
}
template <typename T>
__device__ __forceinline__ int acc_col(int b, int r) {
  return b * Tc<T>::kN + 2 * (threadIdx.x & 3) + (r & 1);
}

// ---------------------------------------------------------------------------
// The line kernel: one axis, tiles of lines, three epilogues
// ---------------------------------------------------------------------------

enum LineMode { kStore = 0, kGain = 1, kBeta1 = 2 };

// out[j][a, i, c] = sum_m mat[i, m] ph_j[m] in[j / in_div][a, m, c] on grids
// of shape (A, n, C) around the transformed axis; a line is one (a, c) pair.
//  kStore: unit (j, tile), out = the transform.
//  kGain:  unit (e, group r, tile); both streams j = 2 (e cn + b) + {0, 1} of
//          each node b of the group, in node order:
//          s[e, r] = sum_b w_b Re(g1_b g2_b) (the real out_real).
//  kBeta1: unit (e, tile); y[e] += sum_g beta1(rho_g, |l|) transform(in[e ng
//          + g]), groups in order, starting from y's value.
template <typename T>
struct LineArgs {
  using C2 = typename Cplx<T>::type;
  const void* in;
  long long in_grid;
  int in_div;
  C2* out;
  T* out_real;
  int a, n, c;
  const C2* mat;
  const C2* phase;
  int phase_rows;
  // kGain
  const T* w;
  int cn, gs, ng;
  // kBeta1
  const T* rho;
  const T* norm_l;
  C2* y;
  long long y_stride;
  T coef, amp, eps;
  // the tiling
  long long n_units;
  int n_tiles, lines, nbuf;
};

// kGlobalA: the matrix is not staged; the products read it from device
// memory (an axis whose matrix and tile do not fit together).
template <typename T, bool kRealIn, int S, int kMode, bool kGlobalA>
__global__ void __launch_bounds__(kTcWarps * 32) line_dft_kernel(const LineArgs<T> p) {
  using C2 = typename Cplx<T>::type;
  using In = typename std::conditional<kRealIn, T, C2>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int np = pad16(p.n);
  const int L = p.lines;
  const int ld = L + (sizeof(T) == 4 ? kLinePad32 : 0);
  const long long tile_elems = (long long)np * ld;
  const long long mat_sm = kGlobalA ? 0 : mat_bytes(p.n);
  const void* a_src = kGlobalA ? static_cast<const void*>(p.mat) : smem;
  In* raw = reinterpret_cast<In*>(smem + mat_sm);
  T* acc_sm = reinterpret_cast<T*>(smem + mat_sm +
                                   (long long)p.nbuf * S * tile_elems * sizeof(C2));
  const int n_lines = p.a * p.c;
  const long long grid_elems = (long long)n_lines * p.n;
  const int tid = threadIdx.x, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int groups_n = L / 16, groups = (np / 16) * groups_n;

  // zero every tile (the padded rows are never loaded), stage the matrix
  for (long long e = tid; e < p.nbuf * S * tile_elems; e += blockDim.x) raw[e] = In{};
  if (!kGlobalA) stage_matrix<T>(smem, p.mat, p.n);
  __syncthreads();

  // Everything an item (step q of unit u) needs, worked out once.
  struct Item {
    long long grid[S];  // input grid of each stream
    long long out;      // output grid (kGain: the group sum; kBeta1: entry)
    int l0, steps;
    T w;  // kGain: the node weight; kBeta1: coef * rho of the group
  };
  auto item_of = [&](long long u, int q) -> Item {
    Item it;
    const long long rest = u / p.n_tiles;
    it.l0 = (int)(u - rest * p.n_tiles) * L;
    if (kMode == kGain) {
      const long long e = rest / p.ng;
      const int r = (int)(rest - e * p.ng);
      it.steps = min(p.gs, p.cn - r * p.gs);
#pragma unroll
      for (int s = 0; s < S; ++s) it.grid[s] = (e * p.cn + r * p.gs + q) * 2 + s;
      it.out = e * p.ng + r;
      it.w = p.w[r * p.gs + q];
    } else if (kMode == kBeta1) {
      it.steps = p.ng;
      it.grid[0] = rest * p.ng + q;
      it.out = rest;
      it.w = p.coef * p.rho[q * p.gs];
    } else {
      it.steps = 1;
      it.grid[0] = rest;
      it.out = rest;
      it.w = 0;
    }
    return it;
  };
  // offset of line l inside its grid (the x axis: l itself)
  auto line_off = [&](int l) -> long long {
    return p.a == 1 ? (long long)l : (long long)(l / p.c) * p.n * p.c + (l % p.c);
  };
  // each thread keeps one line of the tile (blockDim is a multiple of L)
  const int my_lt = tid % L, m0 = tid / L, m_step = blockDim.x / L;
  auto issue = [&](const Item& it, int buf) {
    const int l = it.l0 + my_lt;
    const bool ok = l < n_lines;
    const long long loff = ok ? line_off(l) : 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const long long g = p.in_div == 1 ? it.grid[s] : it.grid[s] / p.in_div;
      const In* src = reinterpret_cast<const In*>(p.in) + g * p.in_grid + loff;
      In* dst = raw + (long long)(buf * S + s) * tile_elems + my_lt;
      for (int m = m0; m < p.n; m += m_step)
        cp_async<sizeof(In)>(dst + m * ld, ok ? src + (long long)m * p.c : src, ok);
    }
    cp_async_commit();
  };

  long long u = blockIdx.x;
  int q = 0, buf = 0;
  Item it;
  if (u < p.n_units) {
    it = item_of(u, 0);
    issue(it, 0);
  }
  while (u < p.n_units) {
    long long u2 = u;
    int q2 = q + 1;
    if (q2 >= it.steps) {
      u2 = u + gridDim.x;
      q2 = 0;
    }
    Item next = it;
    if (u2 < p.n_units) next = item_of(u2, q2);
    if (p.nbuf == 2) {
      if (u2 < p.n_units) issue(next, buf ^ 1);
      else cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    In* tiles = raw + (long long)buf * S * tile_elems;
    // the phase of each stream, folded into its tile once (real inputs
    // take none)
    if constexpr (!kRealIn) {
      if (p.phase != nullptr) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const long long j = it.grid[s];
          const C2* row = p.phase + ((j >> 1) % p.phase_rows) * (long long)p.n;
          for (int m = m0; m < p.n; m += m_step) {
            C2 f = __ldg(row + m);
            if (j & 1) f.y = -f.y;
            In& x = tiles[s * tile_elems + m * ld + my_lt];
            x = cmul(f, x);
          }
        }
        __syncthreads();
      }
    }
    auto bcol = [&](int s, int nn) -> const In* { return tiles + s * tile_elems + nn; };
    const bool first = q == 0, last = q == it.steps - 1;

    for (int tg = warp; tg < groups; tg += nwarps) {
      const int i0 = (tg / groups_n) * 16, n0 = (tg % groups_n) * 16;
      TileAcc<T, S> acc;
      tile_product<T, S, In, kGlobalA>(a_src, p.n, i0, n0, bcol, ld, acc);
#pragma unroll
      for (int b = 0; b < Tc<T>::kWN; ++b)
#pragma unroll
        for (int rc = 0; rc < 2; ++rc) {
          const int lt = n0 + acc_col<T>(b, rc), l = it.l0 + lt;
          const long long loff = l < n_lines ? line_off(l) : 0;
#pragma unroll
          for (int a = 0; a < Tc<T>::kWM; ++a)
#pragma unroll
            for (int r = rc; r < Tc<T>::kAcc; r += 2) {
              const int i = i0 + acc_row<T>(a, r);
              const bool valid = i < p.n && l < n_lines;
              const long long off = loff + (long long)i * p.c;
              const T re = acc.re[0][a][b][r], im = acc.im[0][a][b][r];
              if (kMode == kStore) {
                if (valid) {
                  C2 v;
                  v.x = re;
                  v.y = im;
                  p.out[it.out * grid_elems + off] = v;
                }
              } else if (kMode == kGain) {
                T sacc = first ? T(0) : acc_sm[i * L + lt];
                sacc = sacc + it.w * (re * acc.re[S - 1][a][b][r] - im * acc.im[S - 1][a][b][r]);
                if (!last) acc_sm[i * L + lt] = sacc;
                else if (valid) p.out_real[it.out * grid_elems + off] = sacc;
              } else {
                C2* cacc = reinterpret_cast<C2*>(acc_sm);
                C2 v;
                v.x = 0;
                v.y = 0;
                if (!first) v = cacc[i * L + lt];
                else if (valid) v = p.y[it.out * p.y_stride + off];
                if (valid) {
                  const T arg = it.w * p.norm_l[off] + p.eps;
                  const T b1 = p.amp * dev_sin(arg) / arg;
                  v.x = v.x + b1 * re;
                  v.y = v.y + b1 * im;
                }
                if (!last) cacc[i * L + lt] = v;
                else if (valid) p.y[it.out * p.y_stride + off] = v;
              }
            }
        }
    }
    __syncthreads();
    if (p.nbuf == 1 && u2 < p.n_units) issue(next, 0);
    buf = p.nbuf == 2 ? buf ^ 1 : 0;
    u = u2;
    q = q2;
    it = next;
  }
  cp_async_wait<0>();
}

// Blocks that keep every SM busy: the occupancy of one SM times the SMs.
template <typename K>
cudaError_t persistent_grid(K kernel, int threads, long long smem, long long units,
                            int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                           (size_t)smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = (int)std::min<long long>(units, (long long)per_sm * sms);
  return cudaSuccess;
}

// One line-kernel launch; the caller fills the grid and mode fields of p.
template <typename T, bool kRealIn, int S, int kMode>
cudaError_t line_dft(LineArgs<T> p, long long units_per_tile, cudaStream_t st) {
  using C2 = typename Cplx<T>::type;
  const int acc_bytes = kMode == kStore ? 0 : (kMode == kGain ? (int)sizeof(T) : (int)sizeof(C2));
  const LinePlan lp = line_plan(p.n, S, acc_bytes, (int)sizeof(C2));
  if (lp.lines == 0) return cudaErrorInvalidConfiguration;
  p.lines = lp.lines;
  p.nbuf = lp.nbuf;
  p.n_tiles = (p.a * p.c + lp.lines - 1) / lp.lines;
  p.n_units = units_per_tile * p.n_tiles;
  if (p.n_units == 0) return cudaSuccess;
  const int groups = (pad16(p.n) / 16) * (lp.lines / 16);
  const int threads = 32 * std::min(kTcWarps, groups);
  auto kernel = lp.resident ? line_dft_kernel<T, kRealIn, S, kMode, false>
                            : line_dft_kernel<T, kRealIn, S, kMode, true>;
  int blocks = 0;
  cudaError_t err = persistent_grid(kernel, threads, lp.smem, p.n_units, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, lp.smem, st>>>(p);
  return cudaGetLastError();
}

// One plain axis transform over nbatch grids of shape (A, n, c) (K3's x leg,
// and the y and z passes of the last-pass route).
template <typename T, bool kRealIn>
cudaError_t axis_dft(const void* in, long long in_grid, int in_div,
                     typename Cplx<T>::type* out, long long nbatch, int a, int n,
                     int c, const typename Cplx<T>::type* mat,
                     const typename Cplx<T>::type* phase, int phase_rows,
                     cudaStream_t st) {
  LineArgs<T> p{};
  p.in = in;
  p.in_grid = in_grid;
  p.in_div = in_div;
  p.out = out;
  p.a = a;
  p.n = n;
  p.c = c;
  p.mat = mat;
  p.phase = phase;
  p.phase_rows = phase_rows;
  return line_dft<T, kRealIn, 1, kStore>(p, nbatch, st);
}

// ---------------------------------------------------------------------------
// The plane kernel: the y and z axes of a block of x planes in shared memory
// ---------------------------------------------------------------------------

// out[j][x, i, k] = px_j[x] sum_{m, m'} my[i, m] py_j[m] mz[k, m'] pz_j[m']
//                   in[j / in_div][x, m, m'],  z first, then y
template <typename T>
struct PlaneArgs {
  using C2 = typename Cplx<T>::type;
  const void* in;
  long long in_grid;
  int in_div;
  C2* out;
  int nx, ny, nz, planes;
  const C2* my;
  const C2* mz;
  const C2* px;  // node phases of the three axes (all or none)
  const C2* py;
  const C2* pz;
  int phase_rows;
  long long n_units;
};

template <typename T, bool kRealIn>
__global__ void __launch_bounds__(kPlaneWarps * 32) plane_dft_kernel(const PlaneArgs<T> p) {
  using C2 = typename Cplx<T>::type;
  using In = typename std::conditional<kRealIn, T, C2>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nyp = pad16(p.ny), nzp = pad16(p.nz);
  const int ld_raw = nzp + kRawPad, ld_mid = nzp + (sizeof(T) == 4 ? kLinePad32 : 0);
  const bool share = p.ny == p.nz;
  const int P = p.planes;
  unsigned char* sm_mz = smem;
  unsigned char* sm_my = share ? smem : smem + mat_bytes(p.nz);
  unsigned char* after = smem + mat_bytes(p.nz) + (share ? 0 : mat_bytes(p.ny));
  const long long raw_elems = (long long)P * nyp * ld_raw;
  In* raw = reinterpret_cast<In*>(after);
  C2* mid = reinterpret_cast<C2*>(after + raw_elems * sizeof(C2));
  C2* sph = mid + (long long)P * nyp * ld_mid;  // the unit's phase rows
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;
  const long long blocks_per_grid = p.nx / P;
  const long long n3 = (long long)p.nx * p.ny * p.nz;
  const int plane = p.ny * p.nz;

  for (long long e = tid; e < raw_elems; e += blockDim.x) raw[e] = In{};
  stage_matrix<T>(sm_mz, p.mz, p.nz);
  if (!share) stage_matrix<T>(sm_my, p.my, p.ny);
  __syncthreads();

  auto issue = [&](long long u) {
    const long long j = u / blocks_per_grid;
    const int x0 = (int)(u % blocks_per_grid) * P;
    const In* src = reinterpret_cast<const In*>(p.in) + (j / p.in_div) * p.in_grid +
                    (long long)x0 * plane;
    for (int row = warp; row < P * p.ny; row += nwarps) {  // (plane, y) rows
      const int pl = row / p.ny, yy = row - pl * p.ny;
      for (int zz = lane; zz < p.nz; zz += 32)
        cp_async<sizeof(In)>(raw + (pl * nyp + yy) * ld_raw + zz, src + row * p.nz + zz, true);
    }
    cp_async_commit();
  };

  // z pass: rows z' of mz, lines (plane, y); y pass: rows y' of my, lines
  // (plane, z')
  const int zg_n = P * nyp / 16, zgroups = (nzp / 16) * zg_n;
  const int yg_n = P * nzp / 16, ygroups = (nyp / 16) * yg_n;

  long long u = blockIdx.x;
  if (u < p.n_units) issue(u);
  for (; u < p.n_units; u += gridDim.x) {
    cp_async_wait<0>();
    __syncthreads();
    const long long j = u / blocks_per_grid;
    const int x0 = (int)(u % blocks_per_grid) * P;
    // the node phase of the three axes, ax[x] ay[y] az[z] (conjugated for
    // odd j), staged in shared memory (z padded with zeros): az is folded
    // into the z pass's B fragments, ax ay into its output (diagonal in x
    // and y, they commute with the z transform), so the x pass takes none.
    // Real inputs take no phase.
    const bool phased = !kRealIn && p.pz != nullptr;
    if (phased) {
      const long long prow = (j >> 1) % p.phase_rows;
      const T sgn = (j & 1) ? T(-1) : T(1);
      for (int e = tid; e < P + p.ny + nzp; e += blockDim.x) {
        C2 f;
        f.x = 0;
        f.y = 0;
        if (e < P) f = p.px[prow * p.nx + x0 + e];
        else if (e < P + p.ny) f = p.py[prow * p.ny + e - P];
        else if (e < P + p.ny + p.nz) f = p.pz[prow * p.nz + e - P - p.ny];
        f.y *= sgn;
        sph[e] = f;
      }
      __syncthreads();
    }
    auto zcol = [&](int, int nn) -> const In* { return raw + nn * ld_raw; };
    for (int tg = warp; tg < zgroups; tg += nwarps) {
      const int i0 = (tg / zg_n) * 16, n0 = (tg % zg_n) * 16;
      TileAcc<T, 1> acc;
      tile_product<T, 1, In>(sm_mz, p.nz, i0, n0, zcol, 1, acc,
                             phased ? sph + P + p.ny : nullptr);
#pragma unroll
      for (int b = 0; b < Tc<T>::kWN; ++b)
#pragma unroll
        for (int rc = 0; rc < 2; ++rc) {
          const int nn = n0 + acc_col<T>(b, rc);  // the line (plane, y)
          C2 fxy;
          fxy.x = 1;
          fxy.y = 0;
          if (phased) {
            const int pl = nn / nyp, yy = min(nn - pl * nyp, p.ny - 1);
            fxy = cmul(sph[pl], sph[P + yy]);
          }
#pragma unroll
          for (int a = 0; a < Tc<T>::kWM; ++a)
#pragma unroll
            for (int r = rc; r < Tc<T>::kAcc; r += 2) {
              C2 v;
              v.x = acc.re[0][a][b][r];
              v.y = acc.im[0][a][b][r];
              if (phased) v = cmul(fxy, v);
              mid[nn * ld_mid + i0 + acc_row<T>(a, r)] = v;
            }
        }
    }
    __syncthreads();
    if (u + gridDim.x < p.n_units) issue(u + gridDim.x);

    auto ycol = [&](int, int nn) -> const C2* {
      return mid + (nn / nzp) * nyp * ld_mid + nn % nzp;
    };
    C2* dst = p.out + j * n3 + (long long)x0 * plane;
    for (int tg = warp; tg < ygroups; tg += nwarps) {
      const int i0 = (tg / yg_n) * 16, n0 = (tg % yg_n) * 16;
      TileAcc<T, 1> acc;
      tile_product<T, 1, C2>(sm_my, p.ny, i0, n0, ycol, ld_mid, acc);
#pragma unroll
      for (int b = 0; b < Tc<T>::kWN; ++b)
#pragma unroll
        for (int rc = 0; rc < 2; ++rc) {
          const int nn = n0 + acc_col<T>(b, rc);
          const int pl = nn / nzp, zz = nn - pl * nzp;
          C2* col = dst + (long long)pl * plane + zz;
#pragma unroll
          for (int a = 0; a < Tc<T>::kWM; ++a)
#pragma unroll
            for (int r = rc; r < Tc<T>::kAcc; r += 2) {
              const int yy = i0 + acc_row<T>(a, r);
              if (yy < p.ny && zz < p.nz) {
                C2 v;
                v.x = acc.re[0][a][b][r];
                v.y = acc.im[0][a][b][r];
                col[yy * p.nz] = v;
              }
            }
        }
    }
  }
}

template <typename T, bool kRealIn>
cudaError_t plane_dft(PlaneArgs<T> p, long long nbatch, cudaStream_t st) {
  using C2 = typename Cplx<T>::type;
  const int csize = (int)sizeof(C2);
  p.planes = plane_count(p.nx, p.ny, p.nz, csize);
  if (p.planes == 0) return cudaErrorInvalidConfiguration;
  p.n_units = nbatch * (p.nx / p.planes);
  if (p.n_units == 0) return cudaSuccess;
  const long long smem = plane_smem(p.nx, p.ny, p.nz, csize, p.planes);
  const int zgroups = (pad16(p.nz) / 16) * (p.planes * pad16(p.ny) / 16);
  const int ygroups = (pad16(p.ny) / 16) * (p.planes * pad16(p.nz) / 16);
  const int threads = 32 * std::min(kPlaneWarps, std::max(zgroups, ygroups));
  auto kernel = plane_dft_kernel<T, kRealIn>;
  int blocks = 0;
  cudaError_t err = persistent_grid(kernel, threads, smem, p.n_units, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, st>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K3's element-wise stage
// ---------------------------------------------------------------------------

// y[e * y_stride + p] += sum_g beta1(rho_g, |l|) sh[e, g, p], groups in order
template <typename T>
__global__ void beta1_acc_kernel(const typename Cplx<T>::type* __restrict__ sh,
                                 const T* __restrict__ rho,
                                 const T* __restrict__ norm_l,
                                 typename Cplx<T>::type* __restrict__ y,
                                 long long y_stride, long long n3,
                                 int n_groups, int gs, T coef, T amp, T eps) {
  using C2 = typename Cplx<T>::type;
  const long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (p >= n3) return;
  const int e = blockIdx.y;
  C2 acc = y[e * y_stride + p];
  const T nl = norm_l[p];
  for (int g = 0; g < n_groups; ++g) {
    const T arg = (coef * rho[g * gs]) * nl + eps;
    const T b1 = amp * dev_sin(arg) / arg;
    const C2 v = sh[((long long)e * n_groups + g) * n3 + p];
    acc.x = acc.x + b1 * v.x;
    acc.y = acc.y + b1 * v.y;
  }
  y[e * y_stride + p] = acc;
}

}  // namespace bfft
