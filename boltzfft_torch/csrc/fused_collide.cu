// K1 for Hopper: the whole collision eval Q(f, f) of the fast Fourier spectral
// method, for float and double, any even grid (Nx, Ny, Nz) and a leading batch
// of E distributions.
//
// Replaces boltzfft/pallas_kernels.py::_fused_ct_kernel (io mode), reached
// through fused_collide -> _fused_gain_ct.  Same math, in natural FFT order:
//
//   f_hat   = Fx (x) Fy (x) Fz f                         (forward, unnormalised)
//   loss    = Re IDFT(beta2 f_hat)
//   per node b:  g1 = (Vx diag ax_b) (x) (Vy diag ay_b) (x) (Vz diag az_b) f_hat
//                g2 = the same with conj(a*_b)
//   per radial group r:  s_r = sum_{b in r} w_b Re(g1 g2)   (Im dropped exactly:
//                beta1 is real and even in l, so FFT(i Im h) only feeds the
//                imaginary part that the final Re removes)
//   Q_gain_hat = sum_r beta1(rho_r, |l|) DFT(s_r),
//                beta1 = 4 pi b_gamma sin(a)/a,  a = pi rho_r |l| / (2L) + eps
//   Q       = Re IDFT(Q_gain_hat) - loss * f
//
// V* are the inverse DFT matrices (1/N per axis), F* the forward ones, both
// from weights.build_precomp.
//
// The second entry, bfft_fused_gain_*, is K2 and K4: it replaces
// _fused_ct_kernel in gain-only mode (launch via _fused_gain_ct, reached by
// fused_gain(scheme="ct")) and _fused_gain_kernel (fused_gain(scheme=
// "transpose")).  It takes f_hat and returns Q_gain_hat: K1's node-chunk loop
// (gain_loop below) without the forward transform of f, the loss, the final
// inverses and the assembly.  On the TPU the two differ only in how Mosaic's
// 128-lane tiles are fed (a Cooley-Tukey split of the lane axes against
// per-axis transforms with vector transposes, _dft3).  Here every transform
// is a dense per-axis DFT with the node phase folded in, which is _dft3's
// algorithm, so one entry serves both; the wrappers keep JAX's grid checks
// (any even grid for ct, cubic for transpose).  Its bound is the same
// arithmetic as K1's, less the four transforms it skips.
//
// What bounds it on this card: arithmetic.  Every transform is a dense N-term
// DFT along one axis, O(N) FLOPs per point per axis; per node two streams of
// three axes at 8 real FLOPs per complex multiply-add give 48 N^4 FLOPs, so an
// eval costs about 10 GFLOP at 32^3 and 310 GFLOP at 64^3 (Ns = 12, 192 and
// 384 nodes).  The node streams make three round trips through device memory,
// about 6 * 2B * N^3 complex words: 19 GB at 64^3 in double, 17 FLOP per byte
// against a ridge of 10 for the card's double-precision CUDA cores (35 against
// 20 in float).  The TPU kernel's single-resident layout (~14 N^3 planes in
// VMEM) cannot carry over to 227 KB of shared memory, and neither do its
// Cooley-Tukey split and lane permutations, which exist for the TPU's
// 128-lane tiles.
//
// What the design does about it:
//  * One generic axis-DFT kernel.  A block stages the N x N complex matrix and
//    a tile of 32 lines (each an N-vector along the axis) in shared memory,
//    folding the per-node phase into the tile as it loads.  Each lane owns a
//    line, each warp a run of kRows outputs of it, so every matrix read is a
//    warp broadcast and every input value is reused kRows times from a
//    register.  All arithmetic is IEEE float/double fma on the CUDA cores.
//  * Nodes go in chunks of whole radial groups, sized by the caller from the
//    free device memory; launches per eval are 8 + 8 * chunks, not O(nodes).
//  * No float atomics: the group sum walks its nodes in order inside one
//    thread, and beta1 accumulation walks the groups in order, chunk after
//    chunk, so an eval is bitwise reproducible and a batched eval is bitwise
//    equal to per-item evals.  Padded nodes carry gain_w = 0 and add 0.
//
// Each entry point returns cudaGetLastError() of the first launch that fails,
// or 0; it launches on the given stream, does not synchronise and allocates
// nothing (the caller passes every buffer).

#include "spectral_common.cuh"

namespace {

using bfft::Cplx;
using bfft::axis_dft;
using bfft::beta1_acc_kernel;
using bfft::group_sum_kernel;

// y[e, 0] = 0, y[e, 1] = beta2 * f_hat[e]
template <typename T>
__global__ void init_kernel(const typename Cplx<T>::type* __restrict__ fh,
                            const T* __restrict__ beta2,
                            typename Cplx<T>::type* __restrict__ y,
                            long long n3) {
  using C2 = typename Cplx<T>::type;
  const long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (p >= n3) return;
  const int e = blockIdx.y;
  const C2 v = fh[e * n3 + p];
  const T b = beta2[p];
  C2 z;
  z.x = 0;
  z.y = 0;
  C2 bv;
  bv.x = b * v.x;
  bv.y = b * v.y;
  y[(2LL * e) * n3 + p] = z;
  y[(2LL * e + 1) * n3 + p] = bv;
}

// q[e] = Re yi[e, 0] - Re yi[e, 1] * f[e]
template <typename T>
__global__ void assemble_kernel(const typename Cplx<T>::type* __restrict__ yi,
                                const T* __restrict__ f, T* __restrict__ q,
                                long long n3) {
  const long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (p >= n3) return;
  const int e = blockIdx.y;
  q[e * n3 + p] =
      yi[(2LL * e) * n3 + p].x - yi[(2LL * e + 1) * n3 + p].x * f[e * n3 + p];
}

// Three axis DFTs x, y, z: in -> t -> u -> out, phases optional.
template <typename T, bool kRealIn>
cudaError_t dft3(const void* in, int in_div, typename Cplx<T>::type* t,
                 typename Cplx<T>::type* u, typename Cplx<T>::type* out,
                 int nbatch, int nx, int ny, int nz,
                 const typename Cplx<T>::type* mx,
                 const typename Cplx<T>::type* my,
                 const typename Cplx<T>::type* mz,
                 const typename Cplx<T>::type* px,
                 const typename Cplx<T>::type* py,
                 const typename Cplx<T>::type* pz, int phase_rows,
                 cudaStream_t st) {
  const long long n3 = (long long)nx * ny * nz;
  cudaError_t err = axis_dft<T, kRealIn>(in, n3, in_div, t, nbatch, 1, nx,
                                         ny * nz, mx, px, phase_rows, st);
  if (err != cudaSuccess) return err;
  err = axis_dft<T, false>(t, n3, 1, u, nbatch, nx, ny, nz, my, py,
                           phase_rows, st);
  if (err != cudaSuccess) return err;
  return axis_dft<T, false>(u, n3, 1, out, nbatch, nx * ny, nz, 1, mz, pz,
                            phase_rows, st);
}

// The node-chunk loop shared by K1 and the gain-only entry (K2/K4): for every
// chunk of whole radial groups, both phased inverse streams of each node, the
// real group sums, their forward transform, and the beta1 accumulation into
// y[e * y_stride + p], groups in order.
template <typename T>
cudaError_t gain_loop(const typename Cplx<T>::type* fh, const T* norm_l,
                      const T* rho, const T* gain_w,
                      const typename Cplx<T>::type* ax,
                      const typename Cplx<T>::type* ay,
                      const typename Cplx<T>::type* az,
                      const typename Cplx<T>::type* vx,
                      const typename Cplx<T>::type* vy,
                      const typename Cplx<T>::type* vz,
                      const typename Cplx<T>::type* fx,
                      const typename Cplx<T>::type* fy,
                      const typename Cplx<T>::type* fz,
                      typename Cplx<T>::type* t1, typename Cplx<T>::type* t2,
                      typename Cplx<T>::type* y, long long y_stride, int ne,
                      int nx, int ny, int nz, int n_nodes, int gs, int chunk,
                      double coef, double amp, double eps, cudaStream_t st) {
  const long long n3 = (long long)nx * ny * nz;
  const int pt = 256;
  const int pblocks = (int)((n3 + pt - 1) / pt);
  cudaError_t err;
  for (int n0 = 0; n0 < n_nodes; n0 += chunk) {
    const int cn = std::min(chunk, n_nodes - n0);
    const int ng = (cn + gs - 1) / gs;
    // both phased inverse streams of every node of the chunk: t1
    err = dft3<T, false>(fh, 2 * cn, t1, t2, t1, 2 * ne * cn, nx, ny, nz, vx,
                         vy, vz, ax + (long long)n0 * nx,
                         ay + (long long)n0 * ny, az + (long long)n0 * nz, cn,
                         st);
    if (err != cudaSuccess) return err;
    // real group sums into t2, forward-transformed back into t1
    T* s = reinterpret_cast<T*>(t2);
    group_sum_kernel<T><<<dim3(pblocks, ne * ng), pt, 0, st>>>(
        t1, gain_w + n0, s, n3, cn, gs, ng);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    err = dft3<T, true>(s, 1, t1, t2, t1, ne * ng, nx, ny, nz, fx, fy, fz,
                        nullptr, nullptr, nullptr, 1, st);
    if (err != cudaSuccess) return err;
    beta1_acc_kernel<T><<<dim3(pblocks, ne), pt, 0, st>>>(
        t1, rho + n0, norm_l, y, y_stride, n3, ng, gs, (T)coef, (T)amp,
        (T)eps);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
int fused_collide(const T* f, const T* beta2, const T* norm_l, const T* rho,
                  const T* gain_w, const typename Cplx<T>::type* ax,
                  const typename Cplx<T>::type* ay,
                  const typename Cplx<T>::type* az,
                  const typename Cplx<T>::type* vx,
                  const typename Cplx<T>::type* vy,
                  const typename Cplx<T>::type* vz,
                  const typename Cplx<T>::type* fx,
                  const typename Cplx<T>::type* fy,
                  const typename Cplx<T>::type* fz,
                  typename Cplx<T>::type* fh, typename Cplx<T>::type* y,
                  typename Cplx<T>::type* t1, typename Cplx<T>::type* t2,
                  T* q, int ne, int nx, int ny, int nz, int n_nodes, int gs,
                  int chunk, double coef, double amp, double eps,
                  cudaStream_t st) {
  const long long n3 = (long long)nx * ny * nz;
  const int pt = 256;
  const int pblocks = (int)((n3 + pt - 1) / pt);
  cudaError_t err;

  // f_hat = F f (real input), then y = [0, beta2 f_hat]
  err = dft3<T, true>(f, 1, t1, t2, fh, ne, nx, ny, nz, fx, fy, fz, nullptr,
                      nullptr, nullptr, 1, st);
  if (err != cudaSuccess) return err;
  init_kernel<T><<<dim3(pblocks, ne), pt, 0, st>>>(fh, beta2, y, n3);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  err = gain_loop<T>(fh, norm_l, rho, gain_w, ax, ay, az, vx, vy, vz, fx, fy,
                     fz, t1, t2, y, 2 * n3, ne, nx, ny, nz, n_nodes, gs, chunk,
                     coef, amp, eps, st);
  if (err != cudaSuccess) return err;

  // both final inverses (gain spectrum and beta2 f_hat), then the assembly
  err = dft3<T, false>(y, 1, t1, t2, t1, 2 * ne, nx, ny, nz, vx, vy, vz,
                       nullptr, nullptr, nullptr, 1, st);
  if (err != cudaSuccess) return err;
  assemble_kernel<T><<<dim3(pblocks, ne), pt, 0, st>>>(t1, f, q, n3);
  return cudaGetLastError();
}

// K2/K4: Q_gain_hat of E full spectra f_hat, out = sum_r beta1 DFT(s_r)
template <typename T>
int fused_gain(const typename Cplx<T>::type* fh, const T* norm_l,
               const T* rho, const T* gain_w, const typename Cplx<T>::type* ax,
               const typename Cplx<T>::type* ay,
               const typename Cplx<T>::type* az,
               const typename Cplx<T>::type* vx,
               const typename Cplx<T>::type* vy,
               const typename Cplx<T>::type* vz,
               const typename Cplx<T>::type* fx,
               const typename Cplx<T>::type* fy,
               const typename Cplx<T>::type* fz, typename Cplx<T>::type* t1,
               typename Cplx<T>::type* t2, typename Cplx<T>::type* out,
               int ne, int nx, int ny, int nz, int n_nodes, int gs, int chunk,
               double coef, double amp, double eps, cudaStream_t st) {
  using C2 = typename Cplx<T>::type;
  const long long n3 = (long long)nx * ny * nz;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)ne * n3 * sizeof(C2), st);
  if (err != cudaSuccess) return err;
  return gain_loop<T>(fh, norm_l, rho, gain_w, ax, ay, az, vx, vy, vz, fx, fy,
                      fz, t1, t2, out, n3, ne, nx, ny, nz, n_nodes, gs, chunk,
                      coef, amp, eps, st);
}

}  // namespace

#define BFFT_ENTRY(NAME, T, C2)                                                \
  extern "C" int NAME(                                                         \
      const void* f, const void* beta2, const void* norm_l, const void* rho,   \
      const void* gain_w, const void* ax, const void* ay, const void* az,      \
      const void* vx, const void* vy, const void* vz, const void* fx,          \
      const void* fy, const void* fz, void* fh, void* y, void* t1, void* t2,   \
      void* q, int ne, int nx, int ny, int nz, int n_nodes, int gs, int chunk, \
      double coef, double amp, double eps, void* stream) {                     \
    return fused_collide<T>(                                                   \
        (const T*)f, (const T*)beta2, (const T*)norm_l, (const T*)rho,         \
        (const T*)gain_w, (const C2*)ax, (const C2*)ay, (const C2*)az,         \
        (const C2*)vx, (const C2*)vy, (const C2*)vz, (const C2*)fx,            \
        (const C2*)fy, (const C2*)fz, (C2*)fh, (C2*)y, (C2*)t1, (C2*)t2,       \
        (T*)q, ne, nx, ny, nz, n_nodes, gs, chunk, coef, amp, eps,             \
        (cudaStream_t)stream);                                                 \
  }

BFFT_ENTRY(bfft_fused_collide_f32, float, float2)
BFFT_ENTRY(bfft_fused_collide_f64, double, double2)

#define BFFT_GAIN_ENTRY(NAME, T, C2)                                           \
  extern "C" int NAME(                                                         \
      const void* fh, const void* norm_l, const void* rho, const void* gain_w, \
      const void* ax, const void* ay, const void* az, const void* vx,          \
      const void* vy, const void* vz, const void* fx, const void* fy,          \
      const void* fz, void* t1, void* t2, void* out, int ne, int nx, int ny,   \
      int nz, int n_nodes, int gs, int chunk, double coef, double amp,         \
      double eps, void* stream) {                                              \
    return fused_gain<T>(                                                      \
        (const C2*)fh, (const T*)norm_l, (const T*)rho, (const T*)gain_w,      \
        (const C2*)ax, (const C2*)ay, (const C2*)az, (const C2*)vx,            \
        (const C2*)vy, (const C2*)vz, (const C2*)fx, (const C2*)fy,            \
        (const C2*)fz, (C2*)t1, (C2*)t2, (C2*)out, ne, nx, ny, nz, n_nodes,    \
        gs, chunk, coef, amp, eps, (cudaStream_t)stream);                      \
  }

BFFT_GAIN_ENTRY(bfft_fused_gain_f32, float, float2)
BFFT_GAIN_ENTRY(bfft_fused_gain_f64, double, double2)
