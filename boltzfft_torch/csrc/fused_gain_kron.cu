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
// complex multiply-add that is 1.85 GFLOP per spectrum.  That is 5.7x what
// the function needs: separable per-axis DFTs do it in Nx Ny Nz (Nx + Ny + Nz)
// multiply-adds per transform, 2B + G transforms (G radial groups), 0.33 GFLOP
// per spectrum at 16^3, and that is the bound chip_smoke.py reports.  The node streams
// make one round trip through device memory (written by the y/z product,
// read by the x leg, which forms the group sums): 2 * 2B Nx Ny Nz complex
// words, 25 MB per spectrum in double, 74 FLOP per byte against a ridge of
// 10 (double; 148 against 20 in float).
// The TPU kernel keeps a node block's streams in VMEM; here the streams go
// through device memory, as in K1.
//
// What the design does about it:
//  * The contraction is a shared-memory-tiled complex GEMM on the CUDA cores
//    (kron_gemm_kernel): 64 x 64 output tiles, depth 16 per stage, 4 x 4
//    complex outputs per thread held in registers, IEEE fma only.  The A tile
//    is gathered on the fly: row r is entry (r / Nx) of the stream batch, and
//    the y/z phase of that stream is multiplied in as the tile loads, so no
//    phased copy of f_hat is ever written.  The M (row) tiles run on
//    gridDim.x, so 98,304 streams (512 cells x 96 nodes x 2) fit one launch.
//    The group forward's y/z leg is the same kernel against Ny Nz conj K.
//  * The x leg is K1's x pass of spectral_common.cuh (line_dft_kernel, DMMA
//    in double, 3xTF32 in float): both streams of each node of a radial
//    group, the Hadamard product and the group sum in node order, only the
//    sum written.  The group forward's x leg is the same kernel's plain
//    store; the beta1 accumulation is an element-wise kernel there, whose
//    math is K1's.
//  * Nodes go in chunks of whole radial groups sized by the caller from the
//    free device memory; 5 launches per chunk and one memset per call.
//  * No float atomics: every sum runs in one thread in a fixed order, so a
//    call is bitwise reproducible and a batched call is bitwise equal to
//    per-item calls.  Padded nodes carry gain_w = 0 and add 0.
//
// The entry point returns the cudaError_t of the first launch that fails, or
// 0; it launches on the given stream, does not synchronise and allocates
// nothing (the caller passes every buffer).

#include "spectral_common.cuh"

namespace {

using bfft::Cplx;

constexpr int kBM = 64;  // output rows per block
constexpr int kBN = 64;  // output columns per block
constexpr int kBK = 16;  // contraction depth per shared-memory stage
constexpr int kGemmThreads = 256;

// out[r, n] = sum_k A[r, k] B[k, n] over k = 0 .. K-1 in order, N = K, with
//   A[r, k] = ph_j[k] * in[(j / in_div) * nx + x, k],  j = r / nx, x = r % nx
// and ph_j = stream_phase(phase, phase_rows, j) (none without a table).
// Row-major (M, K), (K, K) and (M, K) complex; blockIdx.x is the row tile.
template <typename T>
__global__ void __launch_bounds__(kGemmThreads) kron_gemm_kernel(
    const typename Cplx<T>::type* __restrict__ in, int in_div, int nx,
    const typename Cplx<T>::type* __restrict__ phase, int phase_rows,
    const typename Cplx<T>::type* __restrict__ b,
    typename Cplx<T>::type* __restrict__ out, long long m_rows, int k_dim) {
  using C2 = typename Cplx<T>::type;
  __shared__ C2 sa[kBK][kBM + 1];  // padded: conflict-free transposed stores
  __shared__ C2 sb[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns tx + 16 j
  const int ty = tid / 16;  // output rows ty + 16 i
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  C2 acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      acc[i][jj].x = 0;
      acc[i][jj].y = 0;
    }
  }

  for (int k0 = 0; k0 < k_dim; k0 += kBK) {
    // A tile (kBM rows x kBK), consecutive threads along k
#pragma unroll
    for (int q = 0; q < (kBM * kBK) / kGemmThreads; ++q) {
      const int idx = tid + q * kGemmThreads;
      const int row = idx / kBK;
      const int kk = idx % kBK;
      const long long r = m0 + row;
      const int k = k0 + kk;
      C2 v;
      v.x = 0;
      v.y = 0;
      if (r < m_rows && k < k_dim) {
        const long long j = r / nx;
        const long long src = (j / in_div) * nx + r % nx;
        v = in[src * k_dim + k];
        if (phase != nullptr)
          v = bfft::cmul(bfft::stream_phase(phase, phase_rows, j, k_dim, k), v);
      }
      sa[kk][row] = v;
    }
    // B tile (kBK x kBN), consecutive threads along n
#pragma unroll
    for (int q = 0; q < (kBK * kBN) / kGemmThreads; ++q) {
      const int idx = tid + q * kGemmThreads;
      const int kk = idx / kBN;
      const int col = idx % kBN;
      const int k = k0 + kk;
      const int n = n0 + col;
      C2 v;
      v.x = 0;
      v.y = 0;
      if (k < k_dim && n < k_dim) v = b[(long long)k * k_dim + n];
      sb[kk][col] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      C2 av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sa[kk][ty + 16 * i];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) bv[jj] = sb[kk][tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) bfft::cmac(acc[i][jj], bv[jj], av[i]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = m0 + ty + 16 * i;
    if (r >= m_rows) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = n0 + tx + 16 * jj;
      if (n < k_dim) out[r * k_dim + n] = acc[i][jj];
    }
  }
}

template <typename T>
cudaError_t kron_gemm(const typename Cplx<T>::type* in, int in_div, int nx,
                      const typename Cplx<T>::type* phase, int phase_rows,
                      const typename Cplx<T>::type* b,
                      typename Cplx<T>::type* out, long long m_rows, int k_dim,
                      cudaStream_t st) {
  const long long m_tiles = (m_rows + kBM - 1) / kBM;
  if (m_tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)m_tiles, (k_dim + kBN - 1) / kBN);
  kron_gemm_kernel<T><<<grid, kGemmThreads, 0, st>>>(
      in, in_div, nx, phase, phase_rows, b, out, m_rows, k_dim);
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
                    typename Cplx<T>::type* out, int ne, int nx, int nyz,
                    int n_nodes, int gs, int chunk, double coef, double amp,
                    double eps, cudaStream_t st) {
  using C2 = typename Cplx<T>::type;
  const long long n3 = (long long)nx * nyz;
  const int pt = 256;
  const int pblocks = (int)((n3 + pt - 1) / pt);
  cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)ne * n3 * sizeof(C2), st);
  if (err != cudaSuccess) return err;

  for (int n0 = 0; n0 < n_nodes; n0 += chunk) {
    const int cn = std::min(chunk, n_nodes - n0);
    const int ng = (cn + gs - 1) / gs;
    const long long streams = 2LL * ne * cn;
    // y/z inverse of both phased streams of every node of the chunk: t1
    err = kron_gemm<T>(fh, 2 * cn, nx, ayz + (long long)n0 * nyz, cn, kinv, t1,
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
    err = kron_gemm<T>(t1, 1, nx, nullptr, 1, kfwd, t2,
                       (long long)ne * ng * nx, nyz, st);
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
      const void* kfwd, const void* norm_l, void* t1, void* t2, void* out,    \
      int ne, int nx, int nyz, int n_nodes, int gs, int chunk, double coef,   \
      double amp, double eps, void* stream) {                                 \
    return fused_gain_kron<T>(                                                \
        (const C2*)fh, (const T*)rho, (const T*)gain_w, (const C2*)ax,        \
        (const C2*)ayz, (const C2*)vx, (const C2*)fx, (const C2*)kinv,        \
        (const C2*)kfwd, (const T*)norm_l, (C2*)t1, (C2*)t2, (C2*)out, ne,    \
        nx, nyz, n_nodes, gs, chunk, coef, amp, eps, (cudaStream_t)stream);   \
  }

BFFT_KRON_ENTRY(bfft_fused_gain_kron_f32, float, float2)
BFFT_KRON_ENTRY(bfft_fused_gain_kron_f64, double, double2)
