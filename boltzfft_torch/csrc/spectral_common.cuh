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
// loses digits).  A warp owns a 16 x 16 output tile, two 16 x 8 mma tiles,
// and steps through the depth 8 complex points at a time:
//  * double: mma.sync m16n8k16 f64 (DMMA; Hopper has no f64 wgmma), the
//    complex step written as one real product of twice the depth, per
//    output part: [Yr] += [Mr -Mi] [Xr; Xi] and [Yi] += [Mi Mr] [Xr; Xi].
//    The two products of one accumulator are then one instruction, never
//    two issued back to back; -Mi is negated in registers from the staged
//    Mi plane (4 sign flips a step, where a third staged plane would cost
//    the 64-point kGain tile its 32 lines).  A real X (Xi = 0) takes one
//    m16n8k8 per part, Mr Xr and Mi Xr.  Accumulated in the fragment over
//    the whole k loop;
//  * float: 3xTF32.  Each operand is split hi = tf32(a), lo = tf32(a - hi)
//    (round to nearest, ties away) and each product is lo*hi + hi*lo + hi*hi
//    (mma.sync m16n8k8 tf32).  The tensor core's adder truncates, and
//    chained over a k loop that bias missed the float32 tolerance on the
//    card, so each k8 step puts each hi*hi product into a zeroed fragment of
//    its own and chains only the small terms, and float adds (round to
//    nearest) gather them into the accumulator.  Single-pass TF32 keeps
//    about three digits and is never used, not even for
//    fused_precision="default".
// Along the y and z axes of 64-point double planes the plane route does not
// take the dense product: it factors the matrix as a two-stage Cooley-Tukey
// DFT, 64 = 8 * 8, on DMMA m16n8k16 (the split, just above
// plane_dft_kernel), 16 complex multiply-adds a point and axis instead of 64,
// the tables taken from the entries of the matrix it is given.  Other axis
// lengths, and float, keep the dense tile.
// What bounds the transforms now.  The dense tiles (the x line passes, every
// axis of other lengths): the tensor-core arithmetic, at m16n8k16's rate in
// double (61-67 TFLOP/s on an H100 from registers, where m8n8k4 stops at
// 33: tools/dmma_probe.cu), then the shared-memory reads that feed it, then
// the streams' bytes that are left (one write and one read of every stream,
// two on the route for large planes).  The split
// plane pass: the least time is its bytes (each 64^3 stream written once:
// 0.96 ms per 64^3 eval at 3.35 TB/s), then its arithmetic (0.77 ms at the
// DMMA peak); measured, its in-place passes (the products with the
// shared-memory reads and writes around them) take most of its time.
// What the design does about it:
//  * The matrix goes into shared memory once per block (zero-padded to a
//    multiple of 16, pre-split for float) and the block walks many tiles
//    in a persistent loop; tiles are double-buffered with cp.async where
//    shared memory allows, so loads overlap the products.  The fragments'
//    reads are free of bank conflicts: the matrix rows are padded by
//    kMatPad, and in double the tiles' rows by kLinePad64 (tile_pad).  The
//    plane kernel's blocks of up to 16 warps hold a thread to 128
//    registers, where two steps' m16n8k16 fragments spill: its double tile
//    reads each step's fragments just before the products (kPrefetch
//    false), the line kernel's (8 warps, 255 registers) a step ahead.
//    Along an axis whose matrix and tile do not fit together (over 96
//    points), the line kernel reads its A fragments from the matrix in
//    device memory instead (L2-resident; split per fragment in float, the
//    same bits), with the same k loop and so the same result.
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
//    block fits, else y and z as line passes (the last-pass route), which
//    axis fits no tile at all, and whether the plane block takes the split.
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
constexpr int kLinePad64 = 2;       // double tile row padding (B loads)
constexpr int kSplitN = 64;         // the axis length the split takes (y and z)
constexpr int kSplitR = 8;          // its factors: kSplitN = kSplitR * kSplitR
constexpr int kSplitPad = 1;        // split block row padding (column reads)
constexpr int kSplitWarps = 8;      // warps of a split block

__host__ __device__ inline int pad16(int n) { return (n + kPad - 1) / kPad * kPad; }

// Row padding of a B operand's tile (complex points): a line tile, or the
// plane kernel's z-pass planes.  In double one 16-byte B load of 8 lanes
// reads depths t + 4 q (t = 0..3) at columns g (g = 0, 1); rows of a
// multiple of 8 points put the four depths on one bank, rows padded by
// kLinePad64 put the 8 points on distinct banks.  A line tile whose matrix
// is not resident keeps unpadded rows, so the longest axes keep the tiles
// they fit.
__host__ __device__ inline int tile_pad(int csize, bool resident) {
  return csize == 8 ? kLinePad32 : (resident ? kLinePad64 : 0);
}

// The split's factor for the y and z axes of a plane block: kSplitR where
// both are kSplitN points and the type is double (csize 16), else 0 (the
// dense tile).
__host__ __device__ inline int plane_split(int ny, int nz, int csize) {
  return csize == 16 && ny == kSplitN && nz == kSplitN ? kSplitR : 0;
}

// A split block: one x plane of ny rows of nz + kSplitPad complex points
// (both passes run in place), then a unit's phase rows (its x, ny, nz).
__host__ __device__ inline long long split_smem(int ny, int nz) {
  return ((long long)ny * (nz + kSplitPad) + 1 + ny + nz) * 16;
}

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
  const int ld = lines + tile_pad(csize, resident);
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
// a unit's phase rows.  A block that takes the split holds one plane
// (split_smem) and no matrix.
__host__ __device__ inline long long plane_smem(int nx, int ny, int nz, int csize, int planes) {
  if (plane_split(ny, nz, csize)) return split_smem(ny, nz);
  const long long mats = mat_bytes(nz) + (ny == nz ? 0 : mat_bytes(ny));
  const int ld_raw = pad16(nz) + kRawPad;
  const int ld_mid = pad16(nz) + tile_pad(csize, true);
  return mats + (long long)planes * pad16(ny) * (ld_raw + ld_mid) * csize +
         (long long)(nx + ny + pad16(nz)) * csize;
}

// x planes per plane-kernel block: the largest divisor of nx whose block
// holds at most kPlaneElems padded points and fits; 0 when one plane does
// not fit (then y and z run as line passes).  A split block holds one.
__host__ __device__ inline int plane_count(int nx, int ny, int nz, int csize) {
  if (plane_split(ny, nz, csize)) return split_smem(ny, nz) <= kSmemLimit ? 1 : 0;
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
// smallest tile needs, out[3] the split's factor on the plane route (0: the
// dense tile).  x runs the gain, beta1 and store passes; y and z run store
// passes where a plane does not fit.
__host__ __device__ inline void k1_plan(int nx, int ny, int nz, int csize, int* out) {
  out[0] = 0;
  out[1] = -1;
  out[2] = 0;
  out[3] = 0;
  plan_fit(0, line_plan(nx, 2, csize / 2, csize), out);
  plan_fit(0, line_plan(nx, 1, csize, csize), out);
  plan_fit(0, line_plan(nx, 1, 0, csize), out);
  const bool planes = plane_count(nx, ny, nz, csize) > 0;
  if (!planes) {
    plan_fit(1, line_plan(ny, 1, 0, csize), out);
    plan_fit(2, line_plan(nz, 1, 0, csize), out);
  }
  out[0] = out[1] >= 0 ? 0 : (planes ? 1 : 2);
  if (out[0] == 1) out[3] = plane_split(ny, nz, csize);
}

// ---------------------------------------------------------------------------
// Tensor-core fragments
// ---------------------------------------------------------------------------

// A warp owns 16 x 16 output tiles: 1 x 2 mma tiles (16 x 8) in both
// precisions, k steps of kK complex points.  kAcc: accumulator values per
// thread and tile, at rows (lane / 4) + 8 (r / 2), columns 2 (lane % 4) + r % 2.
template <typename T> struct Tc {
  static constexpr int kM = 16, kN = 8, kK = 8, kWM = 1, kWN = 2, kAcc = 4;
};

// The m16n8k8 shape of DMMA (sm_90): fragments laid out as mma_tf32's.
__device__ __forceinline__ void mma_dmma16(double (&d)[4], const double (&a)[4],
                                           const double (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// The m16n8k16 shape of DMMA (sm_90): A value i at row g + 8 (i % 2),
// column t + 4 (i / 2); B value i at row t + 4 i, column g; C as m16n8k8.
__device__ __forceinline__ void mma_dmma16k16(double (&d)[4], const double (&a)[8],
                                              const double (&b)[4]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
        "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
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
// order; with kPrefetch the fragments of step k + 1 are read while step k
// multiplies, else each step's just before its products.  A
// lane's A value q sits at row g + 8 (q % 2), depth t + 4 (q / 2) of the
// step, its B value q of each n8 tile at depth t + 4 q, column g (lane =
// 4 g + t): m16n8k8's layout, which m16n8k16 extends by the imaginary half.
template <typename T, int S> struct Frags;
template <int S> struct Frags<double, S> {
  double ar[4], ai[4];
  double2 b[S][Tc<double>::kWN][2];
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
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int off = (q & 1) * 8 * ld + (q >> 1) * 4;
    if constexpr (kGlobalA) {
      const C2 v = mat_at(gm, n_mat, a_row + (q & 1) * 8, k0 + t + (q >> 1) * 4);
      if constexpr (sizeof(T) == 8) {
        f.ar[q] = v.x;
        f.ai[q] = v.y;
      } else {
        tf32_split(v.x, f.arh[q], f.arl[q]);
        tf32_split(v.y, f.aih[q], f.ail[q]);
      }
    } else if constexpr (sizeof(T) == 8) {
      const double* mp = static_cast<const double*>(a_src) + a_row * ld + t + k0;
      f.ar[q] = mp[off];
      f.ai[q] = mp[plane + off];
    } else {
      const uint32_t* mp = static_cast<const uint32_t*>(a_src) + a_row * ld + t + k0;
      f.arh[q] = mp[off];
      f.arl[q] = mp[plane + off];
      f.aih[q] = mp[2 * plane + off];
      f.ail[q] = mp[3 * plane + off];
    }
  }
  // a real B takes no phase (no caller gives one)
  constexpr bool kRealB = std::is_same<In, T>::value;
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int b = 0; b < TC::kWN; ++b)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        C2 v = to_cplx<T>(bp[s][b][(k0 + 4 * q) * sk]);
        if constexpr (!kRealB)
          if (kph != nullptr) v = cmul(kph[k0 + t + 4 * q], v);
        f.b[s][b][q] = v;
      }
}

// One k step of the warp's tile.  kRealB: B is real (Xi = 0).
template <typename T, int S, bool kRealB>
__device__ __forceinline__ void mma_frags(const Frags<T, S>& f, TileAcc<T, S>& acc) {
  using TC = Tc<T>;
  if constexpr (sizeof(T) == 8) {
    if constexpr (kRealB) {
      // Yr += Mr Xr, Yi += Mi Xr: m16n8k8, the A fragments as loaded
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int b = 0; b < TC::kWN; ++b) {
          const double x[2] = {f.b[s][b][0].x, f.b[s][b][1].x};
          mma_dmma16(acc.re[s][0][b], f.ar, x);
          mma_dmma16(acc.im[s][0][b], f.ai, x);
        }
    } else {
      // m16n8k16 on the stacked depth: slots t, t + 4 the real parts of the
      // step's points t, t + 4, slots t + 8, t + 12 their imaginary parts;
      // A [Mr -Mi] for Yr and [Mi Mr] for Yi, B [Xr; Xi] for both
      double are[8], aim[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        are[q] = f.ar[q];
        are[4 + q] = -f.ai[q];
        aim[q] = f.ai[q];
        aim[4 + q] = f.ar[q];
      }
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int b = 0; b < TC::kWN; ++b) {
          const double x[4] = {f.b[s][b][0].x, f.b[s][b][1].x, f.b[s][b][0].y,
                               f.b[s][b][1].y};
          mma_dmma16k16(acc.re[s][0][b], are, x);
          mma_dmma16k16(acc.im[s][0][b], aim, x);
        }
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

template <typename T, int S, typename In, bool kGlobalA = false, bool kPrefetch = true,
          class BCol>
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
  constexpr bool kRealB = std::is_same<In, T>::value;
  if constexpr (!kPrefetch) {
#pragma unroll 1
    for (int k0 = 0; k0 < np; k0 += TC::kK) {
      Frags<T, S> f;
      load_frags<T, S, In, kGlobalA>(a_src, n_mat, plane, a_row, ld, k0, bp, sk, kph, f);
      mma_frags<T, S, kRealB>(f, acc);
    }
    return;
  }
  // np is a multiple of 16, so of 2 kK: the steps go in pairs
  Frags<T, S> f0, f1;
  load_frags<T, S, In, kGlobalA>(a_src, n_mat, plane, a_row, ld, 0, bp, sk, kph, f0);
#pragma unroll 1
  for (int k0 = 0; k0 < np; k0 += 2 * TC::kK) {
    load_frags<T, S, In, kGlobalA>(a_src, n_mat, plane, a_row, ld, k0 + TC::kK, bp, sk,
                                   kph, f1);
    mma_frags<T, S, kRealB>(f0, acc);
    if (k0 + 2 * TC::kK < np)
      load_frags<T, S, In, kGlobalA>(a_src, n_mat, plane, a_row, ld, k0 + 2 * TC::kK, bp,
                                     sk, kph, f0);
    mma_frags<T, S, kRealB>(f1, acc);
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
  const int ld = L + tile_pad((int)sizeof(C2), !kGlobalA);
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

// ---------------------------------------------------------------------------
// The split: a 64-point axis as two 8-point stages on DMMA (double)
// ---------------------------------------------------------------------------
//
// A DFT matrix of N = 64 points, M[k, n] = c w^(k n) (weights.build_precomp's
// dft_pair: c = 1 forward, 1 / N inverse), factors as n = 8 n2 + n1,
// k = k2 + 8 k1:
//   stage 1   Y[k2, n1] = sum_n2 W1[k2, n2] x[8 n2 + n1],  W1[k2, n2] = M[k2, 8 n2] / c
//   twiddle   T[k2, n1] = (M[k2, n1] / c) Y[k2, n1]
//   stage 2   X[k2 + 8 k1] = sum_n1 M[8 k1, n1] T[k2, n1]
// Every table is an entry of the matrix the kernel is given, and c = M[0, 0]
// is a power of two, so the division is exact.  A warp transforms a pair of
// lines in registers with mma.sync m16n8k16 (f64), the complex products
// written as real ones of twice the depth:
//  * stage 1, per line, one product: [Yr; Yi] = [W1r -W1i; W1i W1r]
//    [Xr; Xi], rows k2 (then their imaginary parts), columns n1, depth n2
//    (then again for Xi; a real line takes the m16n8k8 half).  Thread (g, t)
//    reads x[8 t + g] and x[32 + 8 t + g] and is left holding Y[g, 2t] and
//    Y[g, 2t + 1], re and im, which it twiddles.
//  * stage 2, per pair, two products (the real and the imaginary output):
//    those accumulators are stage 2's A fragment as they stand: rows g of
//    the first line and g + 8 of the second, depth slot t <-> Re T[., 2t],
//    t + 4 <-> Re T[., 2t + 1], t + 8 and t + 12 their imaginary parts,
//    against B = [Re; -Im] and [Im; Re] of M[8 k1, n1] in the same slot
//    order.  Thread (g, t) ends with X[g + 16 t] and X[g + 16 t + 8] of both
//    lines.
// So the stages meet in registers, not in shared memory.  The twiddle depends
// on both k2 and n1 and is no factor of either stage's matrix: it is one
// complex multiply per point on the FP64 pipe.  The lane's table entries (6
// complex) stay in registers for the whole persistent loop.  Each output is
// summed in one thread in a fixed order (stage 1's depth, then stage 2's),
// so results stay bitwise reproducible, a batch equal to per-item calls.

// The lane's fragments of the split: stage 1's A ([W1r; W1i] at depth t
// and t + 4, then [-W1i; W1r] at t + 8 and t + 12), the twiddles of (g, 2t)
// and (g, 2t + 1), stage 2's B for the real and the imaginary output
// (M[8 g, 2t] and M[8 g, 2t + 1]: re, re, -im, -im and im, im, re, re).
struct SplitFrags {
  double a1[8];
  double2 tw[2];
  double b2re[4], b2im[4];
};

__device__ __forceinline__ SplitFrags split_frags(const double2* m) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const double inv_c = 1.0 / __ldg(m).x;  // 1 or N: exact
  SplitFrags s;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const double2 w = __ldg(m + g * kSplitN + kSplitR * (t + 4 * h));
    s.a1[2 * h] = w.x * inv_c;
    s.a1[2 * h + 1] = w.y * inv_c;
    s.a1[4 + 2 * h] = -(w.y * inv_c);
    s.a1[5 + 2 * h] = w.x * inv_c;
    const double2 v = __ldg(m + g * kSplitN + 2 * t + h);
    s.tw[h].x = v.x * inv_c;
    s.tw[h].y = v.y * inv_c;
    const double2 b = __ldg(m + kSplitR * g * kSplitN + 2 * t + h);
    s.b2re[h] = b.x;
    s.b2re[2 + h] = -b.y;
    s.b2im[h] = b.y;
    s.b2im[2 + h] = b.x;
  }
  return s;
}

// Stage 1 and the twiddle of one line, x0 = x[8 t + g], x1 = x[32 + 8 t + g]:
// c = T[g, 2t], T[g, 2t + 1] (re), then the same (im).
template <bool kRealIn>
__device__ __forceinline__ void split_stage1(const SplitFrags& s, double2 x0, double2 x1,
                                             double (&c)[4]) {
  c[0] = c[1] = c[2] = c[3] = 0;
  if constexpr (kRealIn) {
    const double a[4] = {s.a1[0], s.a1[1], s.a1[2], s.a1[3]};
    const double b[2] = {x0.x, x1.x};
    mma_dmma16(c, a, b);
  } else {
    const double b[4] = {x0.x, x1.x, x0.y, x1.y};
    mma_dmma16k16(c, s.a1, b);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const double yr = c[h], yi = c[2 + h];
    c[h] = s.tw[h].x * yr - s.tw[h].y * yi;
    c[2 + h] = s.tw[h].x * yi + s.tw[h].y * yr;
  }
}

// Lines la and lb of buf transformed in place (element e of line l at
// buf[l * ls + e * es]): ph, if given, the phase along the lines, folded
// into the input; fa, fb factors of the two lines' outputs (applied where
// ph is given).  A real line is read from the .x of each element.
template <bool kRealIn>
__device__ __forceinline__ void split_pair(const SplitFrags& s, double2* buf, int la, int lb,
                                           int ls, int es, const double2* ph, double2 fa,
                                           double2 fb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int i0 = 8 * t + g, i1 = i0 + 32;
  double c[2][4];
  const int lines[2] = {la, lb};
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    double2* line = buf + lines[q] * ls;
    double2 x0, x1;
    if constexpr (kRealIn) {
      x0.x = reinterpret_cast<const double*>(line + i0 * es)[0];
      x1.x = reinterpret_cast<const double*>(line + i1 * es)[0];
      x0.y = x1.y = 0;
    } else {
      x0 = line[i0 * es];
      x1 = line[i1 * es];
      if (ph != nullptr) {
        x0 = cmul(ph[i0], x0);
        x1 = cmul(ph[i1], x1);
      }
    }
    split_stage1<kRealIn>(s, x0, x1, c[q]);
  }
  const double a[8] = {c[0][0], c[1][0], c[0][1], c[1][1], c[0][2], c[1][2], c[0][3], c[1][3]};
  double orr[4] = {0, 0, 0, 0}, oi[4] = {0, 0, 0, 0};
  mma_dmma16k16(orr, a, s.b2re);
  mma_dmma16k16(oi, a, s.b2im);
  // accumulator r: line r / 2, output g + 16 t + 8 (r % 2)
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    double2 v;
    v.x = orr[r];
    v.y = oi[r];
    if (ph != nullptr) v = cmul(r < 2 ? fa : fb, v);
    buf[lines[r >> 1] * ls + (g + 16 * t + 8 * (r & 1)) * es] = v;
  }
}

// The plane route's block with the split (ny == nz == kSplitN, double): per
// unit (grid j, x plane x0) the plane is loaded with cp.async into rows of
// nz + kSplitPad points (the column reads of the y pass then touch every
// bank), z and y are transformed in place, each warp a pair of lines at a
// time, and the plane is stored, every thread 16 consecutive bytes.  Several
// blocks share an SM, so one block's loads and stores overlap another's
// products.  ny == nz: the z matrix serves both axes, as on the dense tile.
template <bool kRealIn>
__device__ __forceinline__ void plane_split_body(const PlaneArgs<double>& p,
                                                 unsigned char* smem) {
  using In = typename std::conditional<kRealIn, double, double2>::type;
  constexpr int ny = kSplitN, nz = kSplitN, ld = nz + kSplitPad, plane = ny * nz;
  double2* buf = reinterpret_cast<double2*>(smem);
  double2* sph = buf + ny * ld;  // the unit's phase rows: x, y, z
  const int tid = threadIdx.x, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const long long n3 = (long long)p.nx * plane;
  const bool phased = !kRealIn && p.pz != nullptr;
  const SplitFrags s = split_frags(p.mz);
  double2 one;
  one.x = 1;
  one.y = 0;

  for (long long u = blockIdx.x; u < p.n_units; u += gridDim.x) {
    const long long j = u / p.nx;
    const int x0 = (int)(u - j * p.nx);
    const In* src = reinterpret_cast<const In*>(p.in) + (j / p.in_div) * p.in_grid +
                    (long long)x0 * plane;
    for (int e = tid; e < plane; e += blockDim.x) {
      const int yy = e / nz, zz = e - yy * nz;
      cp_async<sizeof(In)>(reinterpret_cast<In*>(buf + yy * ld + zz), src + e, true);
    }
    cp_async_commit();
    if (phased) {  // ax[x0] ay[y] az[z], conjugated for odd j
      const long long prow = (j >> 1) % p.phase_rows;
      const double sgn = (j & 1) ? -1.0 : 1.0;
      for (int e = tid; e < 1 + ny + nz; e += blockDim.x) {
        double2 f;
        if (e == 0) f = p.px[prow * p.nx + x0];
        else if (e <= ny) f = p.py[prow * ny + e - 1];
        else f = p.pz[prow * nz + e - 1 - ny];
        f.y *= sgn;
        sph[e] = f;
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    // z: line y is row y; az folded into the input, ax ay into the output
    for (int q = warp; q < ny / 2; q += nwarps) {
      const int la = 2 * q, lb = la + 1;
      double2 fa = one, fb = one;
      if (phased) {
        fa = cmul(sph[0], sph[1 + la]);
        fb = cmul(sph[0], sph[1 + lb]);
      }
      split_pair<kRealIn>(s, buf, la, lb, ld, 1, phased ? sph + 1 + ny : nullptr, fa, fb);
    }
    __syncthreads();
    // y: line z is column z
    for (int q = warp; q < nz / 2; q += nwarps)
      split_pair<false>(s, buf, 2 * q, 2 * q + 1, 1, ld, nullptr, one, one);
    __syncthreads();
    double2* dst = p.out + j * n3 + (long long)x0 * plane;
    for (int e = tid; e < plane; e += blockDim.x) {
      const int yy = e / nz, zz = e - yy * nz;
      dst[e] = buf[yy * ld + zz];
    }
    __syncthreads();
  }
}

// kSplit: the block of plane_split_body (double only); else the dense tile.
template <typename T, bool kRealIn, bool kSplit>
__global__ void __launch_bounds__(kSplit ? kSplitWarps * 32 : kPlaneWarps * 32, kSplit ? 2 : 1)
    plane_dft_kernel(const PlaneArgs<T> p) {
  using C2 = typename Cplx<T>::type;
  using In = typename std::conditional<kRealIn, T, C2>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (kSplit) {
    plane_split_body<kRealIn>(p, smem);
    return;
  }
  // up to kPlaneWarps warps: 128 registers a thread, where two steps'
  // m16n8k16 fragments spill, so the double tile loads each step's own
  constexpr bool kPlanePrefetch = sizeof(T) == 4;
  const int nyp = pad16(p.ny), nzp = pad16(p.nz);
  const int ld_raw = nzp + kRawPad, ld_mid = nzp + tile_pad((int)sizeof(C2), true);
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
      tile_product<T, 1, In, false, kPlanePrefetch>(sm_mz, p.nz, i0, n0, zcol, 1, acc,
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
      tile_product<T, 1, C2, false, kPlanePrefetch>(sm_my, p.ny, i0, n0, ycol, ld_mid, acc);
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
  int threads = 32 * std::min(kPlaneWarps, std::max(zgroups, ygroups));
  void (*kernel)(const PlaneArgs<T>) = plane_dft_kernel<T, kRealIn, false>;
  if (plane_split(p.ny, p.nz, csize)) {
    if constexpr (sizeof(T) == 8) {
      kernel = plane_dft_kernel<T, kRealIn, true>;
      threads = 32 * kSplitWarps;
    }
  }
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
