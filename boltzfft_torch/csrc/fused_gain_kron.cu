// K3 for Hopper: the gain spectrum Q_gain_hat of the fast Fourier spectral
// method by the Kronecker ("kron") scheme, for float and double, any grid
// (Nx, Ny, Nz) and a leading batch of E spectra.
//
// Replaces boltzfft/pallas_kernels.py::_fused_gain_kron_kernel, reached
// through fused_gain(scheme="kron").  Tensors live as (Nx, Ny*Nz) with the
// (j, k) pair fused, and with K = kron(Vy, Vz) (symmetric; V* the inverse DFT
// matrices, 1/N per axis), per node b and stream s = +-:
//
//   t      = (ayz_b^s * f_hat) K            one (Ny*Nz)-deep contraction
//   g_s    = Vx diag(ax_b^s) t              the x axis, phase folded in
//   s_r    = sum_{b in r} w_b Re(g_+ g_-)   per radial group r, nodes in order
//                                           (Im dropped exactly, as in K1)
//   Q_gain_hat = sum_r beta1(rho_r, |l|) (Fx s_r) (Ny Nz conj K),
//                beta1 = 4 pi b_gamma sin(a)/a,  a = pi rho_r |l| / (2L) + eps
//
// with ax^- = conj(ax), ayz^- = conj(ayz), groups accumulated in order.
//
// What bounds it on this card: arithmetic.  The y/z contraction is a dense
// (Ny Nz)^2 matrix per row, 2 B Nx (Ny Nz)^2 complex multiply-adds per
// spectrum (B nodes): 201M at 16^3 with Ns = 12 (96 nodes), 87% of the eval's
// 231M (the x leg adds 13M, the group forwards 17M).  At 8 real FLOPs per
// complex multiply-add that is 1.85 GFLOP per spectrum, 5.7x what the
// function needs (separable per-axis DFTs: 0.33 GFLOP per spectrum at 16^3,
// the bound chip_smoke.py reports, on the tensor cores).  The node streams
// make one round trip through device memory (written by the y/z product,
// read by the x leg, which forms the group sums): 2 * 2B Nx Ny Nz complex
// words, 25 MB per spectrum in double, 74 FLOP per byte against a DMMA ridge
// of 20 (double; 148 against 49 for 3xTF32 in float).
// The TPU kernel keeps a node block's streams in VMEM; here the streams go
// through device memory, as in K1.
//
// What the design does about it:
//  * The contraction is a complex GEMM on the tensor cores (kron_gemm_kernel),
//    m16n8k8 tiles in both precisions: DMMA in double (sm_90's 16x8x8 shape,
//    faster here than K1's m8n8k4), 3xTF32 in float (bfft::tf32_cmac:
//    each hi*hi product in a zeroed fragment of its own, only the small terms
//    chained, because the tensor core's adder truncates), four real products
//    per complex one.  A block of 8 warps (32 x 32 output tiles each) walks
//    units of rows x columns in a persistent loop, the contraction in
//    double-buffered chunks.  The matrix is split once per call into planes
//    in device memory (split_matrix_kernel; float: tf32 hi/lo); up to
//    pad16(Ny Nz) = 64 (8^3, the default route) a block keeps it resident in
//    shared memory, above that its chunks (32 deep) stream through L2 by
//    cp.async.
//  * The A operand is gathered on the fly: row r is entry (r / Nx) of the
//    stream batch, whose y/z phase is multiplied in as the chunk is staged
//    (then split in float), so no phased copy of f_hat is ever written.  The
//    row arithmetic (divides, the phase row, its conjugation) is worked out
//    once per unit into a shared-memory table; the chunk loads read it.
//    Units run on a 64-bit counter over gridDim.x, so 98,304 streams (512
//    cells x 96 nodes x 2) fit one launch.  The group forward's y/z leg is
//    the same GEMM against Ny Nz conj K.
//  * The x leg is K1's x pass of spectral_common.cuh (line_dft_kernel, DMMA
//    in double, 3xTF32 in float): both streams of each node of a radial
//    group, the Hadamard product and the group sum in node order, only the
//    sum written.  The group forward's x leg is the same kernel's plain
//    store; the beta1 accumulation is an element-wise kernel there, whose
//    math is K1's.
//  * Nodes go in chunks of whole radial groups sized by the caller from the
//    free device memory; 5 launches per chunk, 2 splits and one memset per
//    call.
//  * No float atomics: every output's sum runs in one thread in a fixed
//    order (the GEMM's k loop, nodes, groups), independent of the tiling, so
//    a call is bitwise reproducible and a batched or chunked call is bitwise
//    equal to per-item or one-chunk calls.  Padded nodes carry gain_w = 0
//    and add 0.
//
// The entry point returns the cudaError_t of the first launch that fails, or
// 0; it launches on the given stream, does not synchronise and allocates
// nothing (the caller passes every buffer).

#include "spectral_common.cuh"

namespace {

using bfft::Cplx;

// ---------------------------------------------------------------------------
// The y/z product on the tensor cores (kron_plan is the one count of its
// shared memory; kernels.fused_gain mirrors it)
// ---------------------------------------------------------------------------

constexpr int kGemmWarps = 8;
constexpr int kGemmThreads = 32 * kGemmWarps;
constexpr int kWarpM = 32;          // a warp's output tile, rows
constexpr int kWarpN = 32;          // and columns
constexpr int kResidentK = 64;      // the matrix stays in shared memory up to pad16(k) = 64

// A block's unit, rows x columns, and the contraction depth of a chunk: 128
// x 64 by 16 with the matrix resident, 64 x 128 by 32 streamed (8 warp tiles
// either way; fewer steps where each loads a matrix chunk).  A chunk's rows
// are padded by kMatPad (conflict-free fragment loads).
__host__ __device__ constexpr int gemm_bm(bool resident) { return resident ? 128 : 64; }
__host__ __device__ constexpr int gemm_bn(bool resident) { return resident ? 64 : 128; }
__host__ __device__ constexpr int gemm_bk(bool resident) { return resident ? 16 : 32; }

// K3's GEMM plan for a y/z plane of k points: out[0] 1 when the matrix stays
// in shared memory, out[1] a block's shared-memory bytes, out[2] the column
// tiles, out[3] kp, k padded to whole chunks (the planes are (kp, kp)).  A
// complex point takes 16 bytes in both precisions (double: re, im planes;
// float: re hi, re lo, im hi, im lo as tf32 bits): the matrix (resident,
// rows of kp + kMatPad) or two chunk buffers of it, two chunk buffers of A,
// and two slots of the row table.
__host__ __device__ inline void kron_plan(int k, int* out) {
  const bool res = bfft::pad16(k) <= kResidentK;
  const int bm = gemm_bm(res), bn = gemm_bn(res), bk = gemm_bk(res);
  const int ld = bk + bfft::kMatPad, kp = (k + bk - 1) / bk * bk;
  const long long b = res ? (long long)kp * (kp + bfft::kMatPad) * 16 : 2LL * bn * ld * 16;
  const long long a = 2LL * bm * ld * 16;
  const long long rows = 2LL * bm * (8 + 4);
  out[0] = res ? 1 : 0;
  out[1] = (int)(b + a + rows);
  out[2] = res ? 1 : (kp + bn - 1) / bn;
  out[3] = kp;
}

// The planes of a complex point: double re, im; float re hi, re lo, im hi,
// im lo (tf32 bits).
template <typename T> struct Planes;
template <> struct Planes<double> {
  using type = double;
  static constexpr int kParts = 2;
};
template <> struct Planes<float> {
  using type = uint32_t;
  static constexpr int kParts = 4;
};

// The (k, k) complex matrix b as planes of (kp, kp) points, transposed
// (plane[n][kk] = b[kk][n]: a B column is contiguous in k) and zero-padded;
// in float each value is split once here, not per fragment.
template <typename T>
__global__ void split_matrix_kernel(const typename Cplx<T>::type* __restrict__ b, int k,
                                    int kp, typename Planes<T>::type* __restrict__ out) {
  using C2 = typename Cplx<T>::type;
  const long long plane = (long long)kp * kp;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < plane;
       e += (long long)gridDim.x * blockDim.x) {
    const int n = (int)(e / kp), kk = (int)(e % kp);
    C2 v;
    v.x = 0;
    v.y = 0;
    if (n < k && kk < k) v = b[(long long)kk * k + n];
    if constexpr (sizeof(T) == 8) {
      out[e] = v.x;
      out[plane + e] = v.y;
    } else {
      bfft::tf32_split(v.x, out[e], out[plane + e]);
      bfft::tf32_split(v.y, out[2 * plane + e], out[3 * plane + e]);
    }
  }
}

// out[r, n] = sum_k A[r, k] B[k, n], k = 0 .. K-1 in order (chunks, m16n8k8 steps),
// with A[r, k] = ph_j[k] in[(j / in_div) nx + x, k], j = r / nx, x = r % nx,
// ph_j row (j >> 1) % phase_rows of the phase table, conjugated for odd j
// (the g2 stream of a node; 1 without a table).  Row-major (M, K) and (M, K)
// complex; B is split_matrix_kernel's planes.
template <typename T>
struct GemmArgs {
  using C2 = typename Cplx<T>::type;
  const C2* in;
  int in_div, nx;
  const C2* phase;
  int phase_rows;
  const typename Planes<T>::type* b;
  C2* out;
  int m_rows, k, kp, n_tiles;
  long long units;
};

template <typename T, bool kRes>
__global__ void __launch_bounds__(kGemmThreads, 1) kron_gemm_kernel(const GemmArgs<T> p) {
  using C2 = typename Cplx<T>::type;
  using PT = typename Planes<T>::type;
  using TC = bfft::Tc<float>;  // m16n8k8 tiles in both precisions
  constexpr int kParts = Planes<T>::kParts;
  constexpr int BM = gemm_bm(kRes), BN = gemm_bn(kRes), BK = gemm_bk(kRes);
  constexpr int LD = BK + bfft::kMatPad;
  constexpr int kWarpsN = BN / kWarpN;
  constexpr int MT = kWarpM / TC::kM, NT = kWarpN / TC::kN;  // mma tiles of a warp
  constexpr int kAPer = BM * BK / kGemmThreads;  // A points a thread stages
  constexpr int kRowStep = kGemmThreads / BK;    // rows between them
  constexpr int kPer = 16 / (int)sizeof(PT);     // plane points per 16 bytes
  constexpr int a_plane = BM * LD;
  extern __shared__ __align__(16) unsigned char smem[];

  const int ldb = kRes ? p.kp + bfft::kMatPad : LD;
  const int b_plane = (kRes ? p.kp : BN) * ldb;
  PT* sb = reinterpret_cast<PT*>(smem);
  PT* sa = sb + (kRes ? 1 : 2) * kParts * b_plane;
  long long* row_src = reinterpret_cast<long long*>(sa + 2 * kParts * a_plane);  // [2][BM]
  int* row_ph = reinterpret_cast<int*>(row_src + 2 * BM);                        // [2][BM]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int nch = p.kp / BK;
  const long long gplane = (long long)p.kp * p.kp;

  // the whole matrix, once per block
  if constexpr (kRes) {
    const int gpr = p.kp / kPer, per_part = p.kp * gpr;
    for (int e = tid; e < kParts * per_part; e += kGemmThreads) {
      const int part = e / per_part, rest = e - part * per_part;
      const int row = rest / gpr, q = rest - row * gpr;
      bfft::cp_async<16>(sb + part * b_plane + row * ldb + q * kPer,
                         p.b + part * gplane + (long long)row * p.kp + q * kPer, true);
    }
    bfft::cp_async_commit();
  }

  // The unit's rows, worked out once: row_src the offset of the row's input
  // line (-1 past the last row), row_ph twice the offset of its phase row,
  // plus 1 where it is conjugated (-1 without a table).
  auto set_rows = [&](long long u, int slot) {
    for (int row = tid; row < BM; row += kGemmThreads) {
      const long long r = (u / p.n_tiles) * BM + row;
      long long src = -1;
      int ph = -1;
      if (r < p.m_rows) {
        const int rr = (int)r, j = rr / p.nx, x = rr - j * p.nx;
        src = ((long long)(j / p.in_div) * p.nx + x) * p.k;
        if (p.phase != nullptr) ph = ((j >> 1) % p.phase_rows) * p.k * 2 + (j & 1);
      }
      row_src[slot * BM + row] = src;
      row_ph[slot * BM + row] = ph;
    }
  };
  // A chunk: each thread loads kAPer points (consecutive threads along k)
  // into registers, and after the products phases, splits and stores them
  const int my_k = tid % BK, my_row = tid / BK;
  C2 av[kAPer];
  auto load_a = [&](int slot, int c) {
    const int kg = c * BK + my_k;
#pragma unroll
    for (int q = 0; q < kAPer; ++q) {
      const long long src = row_src[slot * BM + my_row + q * kRowStep];
      av[q].x = 0;
      av[q].y = 0;
      if (src >= 0 && kg < p.k) av[q] = __ldg(p.in + src + kg);
    }
  };
  auto store_a = [&](int slot, int c, int buf) {
    const int kg = c * BK + my_k;
    PT* dst = sa + buf * kParts * a_plane;
#pragma unroll
    for (int q = 0; q < kAPer; ++q) {
      const int row = my_row + q * kRowStep;
      const int ph = row_ph[slot * BM + row];
      C2 v = av[q];
      if (ph >= 0 && kg < p.k) {
        C2 f = __ldg(p.phase + (ph >> 1) + kg);
        if (ph & 1) f.y = -f.y;
        v = bfft::cmul(f, v);
      }
      const int e = row * LD + my_k;
      if constexpr (sizeof(T) == 8) {
        dst[e] = v.x;
        dst[a_plane + e] = v.y;
      } else {
        bfft::tf32_split(v.x, dst[e], dst[a_plane + e]);
        bfft::tf32_split(v.y, dst[2 * a_plane + e], dst[3 * a_plane + e]);
      }
    }
  };
  // a chunk of the matrix (streamed): BN columns from the unit's first, zero
  // past kp
  auto issue_b = [&](long long u, int c, int buf) {
    constexpr int gpr = BK / kPer;
    const int n0 = (int)(u % p.n_tiles) * BN;
    PT* dst = sb + buf * kParts * b_plane;
    for (int e = tid; e < kParts * BN * gpr; e += kGemmThreads) {
      const int part = e / (BN * gpr), rest = e - part * BN * gpr;
      const int row = rest / gpr, q = rest - row * gpr;
      const bool ok = n0 + row < p.kp;
      const PT* src = p.b + part * gplane +
                      (ok ? (long long)(n0 + row) * p.kp + c * BK + q * kPer : 0);
      bfft::cp_async<16>(dst + part * b_plane + row * LD + q * kPer, src, ok);
    }
  };

  T acc_re[MT][NT][TC::kAcc], acc_im[MT][NT][TC::kAcc];
  auto zero_acc = [&]() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < TC::kAcc; ++r) acc_re[mt][nt][r] = acc_im[mt][nt][r] = T(0);
  };
  // the warp's n8 tiles that hold columns below kp (warp-uniform)
  auto live_tiles = [&](long long u) {
    const int base = (int)(u % p.n_tiles) * BN + wn * kWarpN;
    return max(0, min(NT, (p.kp - base) / TC::kN));
  };

  // The products of one chunk, k steps in order: re += Ar Br - Ai Bi,
  // im += Ar Bi + Ai Br.
  auto compute = [&](int buf, int c, int live) {
    const PT* A = sa + buf * kParts * a_plane;
    const PT* B = kRes ? sb : sb + buf * kParts * b_plane;
    const int koff = kRes ? c * BK : 0;
    const int arow = wm * kWarpM + g, brow = wn * kWarpN + g;
#pragma unroll
    for (int kk = 0; kk < BK; kk += TC::kK) {
      if constexpr (sizeof(T) == 8) {
        double ar[MT][4], ai[MT][4], br[NT][2], bi[NT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int e = (arow + mt * TC::kM + (q & 1) * 8) * LD + kk + t + (q >> 1) * 4;
            ar[mt][q] = A[e];
            ai[mt][q] = A[a_plane + e];
          }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            br[nt][q] = bi[nt][q] = 0.0;
            if (nt < live) {
              const int e = (brow + nt * TC::kN) * ldb + koff + kk + t + 4 * q;
              br[nt][q] = B[e];
              bi[nt][q] = B[b_plane + e];
            }
          }
        // Ar B on every tile first, then Ai B: the two products of one
        // accumulator are never issued back to back
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            if (nt < live) {
              bfft::mma_dmma16(acc_re[mt][nt], ar[mt], br[nt]);
              bfft::mma_dmma16(acc_im[mt][nt], ar[mt], bi[nt]);
            }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const double nai[4] = {-ai[mt][0], -ai[mt][1], -ai[mt][2], -ai[mt][3]};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            if (nt < live) {
              bfft::mma_dmma16(acc_re[mt][nt], nai, bi[nt]);
              bfft::mma_dmma16(acc_im[mt][nt], ai[mt], br[nt]);
            }
        }
      } else {
        uint32_t arh[MT][4], arl[MT][4], aih[MT][4], ail[MT][4], naih[MT][4], nail[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int e = (arow + mt * TC::kM + (q & 1) * 8) * LD + kk + t + (q >> 1) * 4;
            arh[mt][q] = A[e];
            arl[mt][q] = A[a_plane + e];
            aih[mt][q] = A[2 * a_plane + e];
            ail[mt][q] = A[3 * a_plane + e];
            naih[mt][q] = aih[mt][q] ^ 0x80000000u;
            nail[mt][q] = ail[mt][q] ^ 0x80000000u;
          }
        uint32_t brh[NT][2], brl[NT][2], bih[NT][2], bil[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            brh[nt][q] = brl[nt][q] = bih[nt][q] = bil[nt][q] = 0u;
            if (nt < live) {
              const int e = (brow + nt * TC::kN) * ldb + koff + kk + t + 4 * q;
              brh[nt][q] = B[e];
              brl[nt][q] = B[b_plane + e];
              bih[nt][q] = B[2 * b_plane + e];
              bil[nt][q] = B[3 * b_plane + e];
            }
          }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            if (nt < live)
              bfft::tf32_cmac(acc_re[mt][nt], acc_im[mt][nt], arh[mt], arl[mt], aih[mt],
                              ail[mt], naih[mt], nail[mt], brh[nt], brl[nt], bih[nt],
                              bil[nt]);
      }
    }
  };
  auto store_out = [&](long long u) {
    const long long m0 = (u / p.n_tiles) * BM + wm * kWarpM;
    const int n0 = (int)(u % p.n_tiles) * BN + wn * kWarpN;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < TC::kAcc; ++r) {
          const long long row = m0 + bfft::acc_row<float>(mt, r);
          const int col = n0 + bfft::acc_col<float>(nt, r);
          if (row < p.m_rows && col < p.k) {
            C2 v;
            v.x = acc_re[mt][nt][r];
            v.y = acc_im[mt][nt][r];
            p.out[row * p.k + col] = v;
          }
        }
  };

  // One step per (unit, chunk): chunk c + 1's A points and matrix chunk are
  // loaded while chunk c multiplies, one barrier per step.
  long long u = blockIdx.x;
  int c = 0, slot = 0, buf = 0;
  zero_acc();
  set_rows(u, 0);
  __syncthreads();
  load_a(0, 0);
  if constexpr (!kRes) issue_b(u, 0, 0);
  bfft::cp_async_commit();
  store_a(0, 0, 0);
  while (true) {
    bfft::cp_async_wait<0>();
    __syncthreads();
    long long u2 = u;
    int c2 = c + 1, slot2 = slot;
    if (c2 == nch) {
      u2 = u + gridDim.x;
      c2 = 0;
      slot2 = slot ^ 1;
    }
    const bool more = u2 < p.units;
    if (more && c2 == 0) {
      set_rows(u2, slot2);
      __syncthreads();
    }
    if (more) {
      load_a(slot2, c2);
      if constexpr (!kRes) issue_b(u2, c2, buf ^ 1);
    }
    bfft::cp_async_commit();
    const int live = live_tiles(u);
    if (live == NT) compute(buf, c, NT);  // every tile: no predicates
    else compute(buf, c, live);
    if (more) store_a(slot2, c2, buf ^ 1);
    if (c == nch - 1) {
      store_out(u);
      zero_acc();
    }
    if (!more) break;
    u = u2;
    c = c2;
    slot = slot2;
    buf ^= 1;
  }
  bfft::cp_async_wait<0>();
}

template <typename T>
cudaError_t split_matrix(const typename Cplx<T>::type* b, int k, int kp,
                         typename Planes<T>::type* out, cudaStream_t st) {
  const long long plane = (long long)kp * kp;
  const int blocks = (int)std::min<long long>((plane + bfft::kThreads - 1) / bfft::kThreads, 1024);
  split_matrix_kernel<T><<<blocks, bfft::kThreads, 0, st>>>(b, k, kp, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t kron_gemm(const typename Cplx<T>::type* in, int in_div, int nx,
                      const typename Cplx<T>::type* phase, int phase_rows,
                      const typename Planes<T>::type* b, typename Cplx<T>::type* out,
                      long long m_rows, int k, cudaStream_t st) {
  if (m_rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  int plan[4];
  kron_plan(k, plan);
  const bool res = plan[0] == 1;
  GemmArgs<T> p{};
  p.in = in;
  p.in_div = in_div;
  p.nx = nx;
  p.phase = phase;
  p.phase_rows = phase_rows;
  p.b = b;
  p.out = out;
  p.m_rows = (int)m_rows;
  p.k = k;
  p.kp = plan[3];
  p.n_tiles = plan[2];
  const int bm = gemm_bm(res);
  p.units = (m_rows + bm - 1) / bm * p.n_tiles;
  if (p.units == 0) return cudaSuccess;
  auto kernel = res ? kron_gemm_kernel<T, true> : kron_gemm_kernel<T, false>;
  int blocks = 0;
  cudaError_t err = bfft::persistent_grid(kernel, kGemmThreads, plan[1], p.units, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kGemmThreads, plan[1], st>>>(p);
  return cudaGetLastError();
}

template <typename T>
int fused_gain_kron(const typename Cplx<T>::type* fh, const T* rho,
                    const T* gain_w, const typename Cplx<T>::type* ax,
                    const typename Cplx<T>::type* ayz,
                    const typename Cplx<T>::type* vx,
                    const typename Cplx<T>::type* fx,
                    const typename Cplx<T>::type* kinv,
                    const typename Cplx<T>::type* kfwd, const T* norm_l,
                    typename Cplx<T>::type* t1, typename Cplx<T>::type* t2,
                    void* ksplit, typename Cplx<T>::type* out, int ne, int nx, int nyz,
                    int n_nodes, int gs, int chunk, double coef, double amp,
                    double eps, cudaStream_t st) {
  using C2 = typename Cplx<T>::type;
  using PT = typename Planes<T>::type;
  const long long n3 = (long long)nx * nyz;
  const int pt = 256;
  const int pblocks = (int)((n3 + pt - 1) / pt);
  int plan[4];
  kron_plan(nyz, plan);
  const int kp = plan[3];
  // the two matrices as planes, (2, Planes::kParts, kp, kp) points
  PT* kinv_s = static_cast<PT*>(ksplit);
  PT* kfwd_s = kinv_s + (long long)Planes<T>::kParts * kp * kp;
  cudaError_t err = split_matrix<T>(kinv, nyz, kp, kinv_s, st);
  if (err != cudaSuccess) return err;
  if ((err = split_matrix<T>(kfwd, nyz, kp, kfwd_s, st)) != cudaSuccess) return err;
  err = cudaMemsetAsync(out, 0, (size_t)ne * n3 * sizeof(C2), st);
  if (err != cudaSuccess) return err;

  for (int n0 = 0; n0 < n_nodes; n0 += chunk) {
    const int cn = std::min(chunk, n_nodes - n0);
    const int ng = (cn + gs - 1) / gs;
    const long long streams = 2LL * ne * cn;
    // y/z inverse of both phased streams of every node of the chunk: t1
    err = kron_gemm<T>(fh, 2 * cn, nx, ayz + (long long)n0 * nyz, cn, kinv_s, t1,
                       streams * nx, nyz, st);
    if (err != cudaSuccess) return err;
    // x inverse with the ax phase folded in, the Hadamard product and the
    // real group sums (K1's kGain pass): s in t2
    T* s = reinterpret_cast<T*>(t2);
    bfft::LineArgs<T> p{};
    p.in = t1;
    p.in_grid = n3;
    p.in_div = 1;
    p.out_real = s;
    p.a = 1;
    p.n = nx;
    p.c = nyz;
    p.mat = vx;
    p.phase = ax + (long long)n0 * nx;
    p.phase_rows = cn;
    p.w = gain_w + n0;
    p.cn = cn;
    p.gs = gs;
    p.ng = ng;
    err = bfft::line_dft<T, false, 2, bfft::kGain>(p, (long long)ne * ng, st);
    if (err != cudaSuccess) return err;
    // forward x into t1, forward y/z into t2
    err = bfft::axis_dft<T, true>(s, n3, 1, t1, (long long)ne * ng, 1, nx, nyz,
                                  fx, nullptr, 1, st);
    if (err != cudaSuccess) return err;
    err = kron_gemm<T>(t1, 1, nx, nullptr, 1, kfwd_s, t2, (long long)ne * ng * nx, nyz, st);
    if (err != cudaSuccess) return err;
    bfft::beta1_acc_kernel<T><<<dim3(pblocks, ne), pt, 0, st>>>(
        t2, rho + n0, norm_l, out, n3, n3, ng, gs, (T)coef, (T)amp, (T)eps);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

#define BFFT_KRON_ENTRY(NAME, T, C2)                                          \
  extern "C" int NAME(                                                        \
      const void* fh, const void* rho, const void* gain_w, const void* ax,    \
      const void* ayz, const void* vx, const void* fx, const void* kinv,      \
      const void* kfwd, const void* norm_l, void* t1, void* t2, void* ksplit, \
      void* out, int ne, int nx, int nyz, int n_nodes, int gs, int chunk,     \
      double coef, double amp, double eps, void* stream) {                    \
    return fused_gain_kron<T>(                                                \
        (const C2*)fh, (const T*)rho, (const T*)gain_w, (const C2*)ax,        \
        (const C2*)ayz, (const C2*)vx, (const C2*)fx, (const C2*)kinv,        \
        (const C2*)kfwd, (const T*)norm_l, (C2*)t1, (C2*)t2, ksplit,          \
        (C2*)out, ne, nx, nyz, n_nodes, gs, chunk, coef, amp, eps,            \
        (cudaStream_t)stream);                                                \
  }

BFFT_KRON_ENTRY(bfft_fused_gain_kron_f32, float, float2)
BFFT_KRON_ENTRY(bfft_fused_gain_kron_f64, double, double2)

// K3's GEMM plan for a y/z plane of k points (kron_plan: 4 ints into out),
// for the wrapper's mirror to be checked against on the card.
extern "C" int bfft_kron_plan(int k, void* out) {
  kron_plan(k, static_cast<int*>(out));
  return 0;
}
