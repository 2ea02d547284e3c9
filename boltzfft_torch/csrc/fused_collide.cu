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
// What bounds it on this card: the tensor-core arithmetic.  Every transform
// is a dense N-term DFT along one axis, O(N) FLOPs per point per axis; per
// node two streams of three axes at 8 real FLOPs per complex multiply-add
// give 48 N^4 FLOPs, so an eval costs about 10 GFLOP at 32^3 and 310 GFLOP
// at 64^3 (Ns = 12, 192 and 384 nodes): 4.6 ms at 64^3 on the DMMA peak (67
// TFLOP/s, double), 1.9 ms as 3xTF32 (3 tf32 products at 495 TFLOP/s).
// Next come the node streams' bytes: each is written once after its y and z
// axes and read once by the x axis, 2 * 2B * N^3 complex words, 6.4 GB at
// 64^3 in double (1.9 ms at 3.35 TB/s).  The TPU kernel's single-resident
// layout (~14 N^3 planes in VMEM) cannot carry over to 227 KB of shared
// memory, and neither do its Cooley-Tukey split and lane permutations, which
// exist for the TPU's 128-lane tiles.
//
// What the design does about it (spectral_common.cuh holds the kernels):
//  * Every axis transform runs on the tensor cores (DMMA in double, 3xTF32
//    in float), the matrix resident in shared memory, tiles streamed by
//    cp.async in a persistent loop, the node phase folded in as fragments
//    are read.
//  * A transform of a batch of grids is two launches: plane_dft_kernel runs
//    y and z on blocks of x planes in shared memory, line_dft_kernel runs x.
//    Where a plane does not fit (k1_plan), y and z are line passes too; along
//    an axis over 96 points the line passes read the matrix from device
//    memory instead of keeping it resident.
//  * The node streams' x axis is fused with the Hadamard product and the
//    group sum (kGain): per (entry, radial group, tile of lines) a block
//    transforms both streams of each node of the group, in node order, and
//    writes only s_r = sum_b w_b Re(g1 g2).  The forward of s_r runs y, z,
//    then x fused with the beta1 sum over groups (kBeta1), groups in order.
//    The streams cross device memory once, and no group-sum pass reads
//    them back.
//  * Nodes go in chunks of whole radial groups, sized by the caller from the
//    free device memory; an eval is 6 + 4 * chunks launches on the plane
//    route (K2/K4: 1 + 4 * chunks).
//  * No float atomics: each output's sums run in one thread in a fixed order
//    (the k loop, the nodes of a group, the groups, chunk after chunk), so
//    an eval is bitwise reproducible, a batched eval is bitwise equal to
//    per-item evals and a chunked eval to one chunk.  Padded nodes carry
//    gain_w = 0 and add 0.
//
// Each entry point returns the cudaError_t of the first launch that fails,
// or 0; it launches on the given stream, does not synchronise and allocates
// nothing (the caller passes every buffer).

#include "spectral_common.cuh"

namespace {

using bfft::Cplx;
using bfft::LineArgs;
using bfft::PlaneArgs;

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

// The grid of an eval and its route.
struct Grid {
  int nx, ny, nz;
  bool planes;  // the plane route (k1_plan)
  long long n3() const { return (long long)nx * ny * nz; }
};

// The y and z axes of nbatch grids in[j / in_div], node phases px, py, pz
// (rows phase_rows; all or none): into a on the plane route, which folds in
// all three phases, else z into a and y into b, and the x phase is left to
// the x pass.  Returns the buffer that holds the result through *res.
template <typename T, bool kRealIn>
cudaError_t dft_yz(const Grid& g, const void* in, int in_div,
                   typename Cplx<T>::type* a, typename Cplx<T>::type* b,
                   long long nbatch, const typename Cplx<T>::type* my,
                   const typename Cplx<T>::type* mz,
                   const typename Cplx<T>::type* px,
                   const typename Cplx<T>::type* py,
                   const typename Cplx<T>::type* pz, int phase_rows,
                   typename Cplx<T>::type** res, cudaStream_t st) {
  const long long n3 = g.n3();
  if (g.planes) {
    PlaneArgs<T> p{};
    p.in = in;
    p.in_grid = n3;
    p.in_div = in_div;
    p.out = a;
    p.nx = g.nx;
    p.ny = g.ny;
    p.nz = g.nz;
    p.my = my;
    p.mz = mz;
    p.px = px;
    p.py = py;
    p.pz = pz;
    p.phase_rows = phase_rows;
    *res = a;
    return bfft::plane_dft<T, kRealIn>(p, nbatch, st);
  }
  cudaError_t err = bfft::axis_dft<T, kRealIn>(in, n3, in_div, a, nbatch, g.nx * g.ny,
                                               g.nz, 1, mz, pz, phase_rows, st);
  if (err != cudaSuccess) return err;
  *res = b;
  return bfft::axis_dft<T, false>(a, n3, 1, b, nbatch, g.nx, g.ny, g.nz, my, py,
                                  phase_rows, st);
}

// The x axis of nbatch grids, a plain store.
template <typename T>
cudaError_t dft_x(const Grid& g, const typename Cplx<T>::type* in,
                  typename Cplx<T>::type* out, long long nbatch,
                  const typename Cplx<T>::type* mx, cudaStream_t st) {
  return bfft::axis_dft<T, false>(in, g.n3(), 1, out, nbatch, 1, g.nx, g.ny * g.nz,
                                  mx, nullptr, 1, st);
}

// The node-chunk loop shared by K1 and the gain-only entry (K2/K4): for every
// chunk of whole radial groups, both phased inverse streams of each node (y
// and z, then x fused with the Hadamard product and the real group sums),
// the forward transform of the group sums (y and z, then x fused with the
// beta1 accumulation into y[e * y_stride + p], groups in order).
template <typename T>
cudaError_t gain_loop(const Grid& g, const typename Cplx<T>::type* fh,
                      const T* norm_l, const T* rho, const T* gain_w,
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
                      int n_nodes, int gs, int chunk, double coef, double amp,
                      double eps, cudaStream_t st) {
  using C2 = typename Cplx<T>::type;
  const long long n3 = g.n3();
  cudaError_t err;
  for (int n0 = 0; n0 < n_nodes; n0 += chunk) {
    const int cn = std::min(chunk, n_nodes - n0);
    const int ng = (cn + gs - 1) / gs;
    // y and z of both phased inverse streams of every node of the chunk
    C2* streams = nullptr;
    const C2* ax0 = ax + (long long)n0 * g.nx;
    err = dft_yz<T, false>(g, fh, 2 * cn, t1, t2, 2LL * ne * cn, vy, vz, ax0,
                           ay + (long long)n0 * g.ny, az + (long long)n0 * g.nz,
                           cn, &streams, st);
    if (err != cudaSuccess) return err;
    // x (with the ax phase on the last-pass route), the Hadamard product
    // and the group sums s (real)
    C2* other = streams == t1 ? t2 : t1;
    T* s = reinterpret_cast<T*>(other);
    LineArgs<T> p{};
    p.in = streams;
    p.in_grid = n3;
    p.in_div = 1;
    p.out_real = s;
    p.a = 1;
    p.n = g.nx;
    p.c = g.ny * g.nz;
    p.mat = vx;
    p.phase = g.planes ? nullptr : ax0;
    p.phase_rows = cn;
    p.w = gain_w + n0;
    p.cn = cn;
    p.gs = gs;
    p.ng = ng;
    err = bfft::line_dft<T, false, 2, bfft::kGain>(p, (long long)ne * ng, st);
    if (err != cudaSuccess) return err;
    // forward y and z of the group sums, then x with the beta1 sum into y
    C2* sh = nullptr;
    err = dft_yz<T, true>(g, s, 1, streams, other, (long long)ne * ng, fy, fz,
                          nullptr, nullptr, nullptr, 1, &sh, st);
    if (err != cudaSuccess) return err;
    LineArgs<T> q{};
    q.in = sh;
    q.in_grid = n3;
    q.in_div = 1;
    q.a = 1;
    q.n = g.nx;
    q.c = g.ny * g.nz;
    q.mat = fx;
    q.phase_rows = 1;
    q.gs = gs;
    q.ng = ng;
    q.rho = rho + n0;
    q.norm_l = norm_l;
    q.y = y;
    q.y_stride = y_stride;
    q.coef = (T)coef;
    q.amp = (T)amp;
    q.eps = (T)eps;
    err = bfft::line_dft<T, false, 1, bfft::kBeta1>(q, ne, st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
Grid make_grid(int nx, int ny, int nz) {
  int plan[3];
  bfft::k1_plan(nx, ny, nz, (int)sizeof(typename Cplx<T>::type), plan);
  return Grid{nx, ny, nz, plan[0] == 1};
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
  using C2 = typename Cplx<T>::type;
  const Grid g = make_grid<T>(nx, ny, nz);
  const long long n3 = g.n3();
  const int pt = bfft::kThreads;
  const int pblocks = (int)((n3 + pt - 1) / pt);
  cudaError_t err;

  // f_hat = F f (real input), then y = [0, beta2 f_hat]
  C2* r = nullptr;
  err = dft_yz<T, true>(g, f, 1, t1, t2, ne, fy, fz, nullptr, nullptr, nullptr, 1,
                        &r, st);
  if (err != cudaSuccess) return err;
  if ((err = dft_x<T>(g, r, fh, ne, fx, st)) != cudaSuccess) return err;
  init_kernel<T><<<dim3(pblocks, ne), pt, 0, st>>>(fh, beta2, y, n3);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  err = gain_loop<T>(g, fh, norm_l, rho, gain_w, ax, ay, az, vx, vy, vz, fx, fy,
                     fz, t1, t2, y, 2 * n3, ne, n_nodes, gs, chunk, coef, amp,
                     eps, st);
  if (err != cudaSuccess) return err;

  // both final inverses (gain spectrum and beta2 f_hat), then the assembly
  err = dft_yz<T, false>(g, y, 1, t1, t2, 2LL * ne, vy, vz, nullptr, nullptr, nullptr,
                         1, &r, st);
  if (err != cudaSuccess) return err;
  C2* yi = r == t1 ? t2 : t1;
  if ((err = dft_x<T>(g, r, yi, 2LL * ne, vx, st)) != cudaSuccess) return err;
  assemble_kernel<T><<<dim3(pblocks, ne), pt, 0, st>>>(yi, f, q, n3);
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
  const Grid g = make_grid<T>(nx, ny, nz);
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)ne * g.n3() * sizeof(C2), st);
  if (err != cudaSuccess) return err;
  return gain_loop<T>(g, fh, norm_l, rho, gain_w, ax, ay, az, vx, vy, vz, fx, fy,
                      fz, t1, t2, out, g.n3(), ne, n_nodes, gs, chunk, coef, amp,
                      eps, st);
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

// K1's shared-memory plan for a grid (bfft::k1_plan: 3 ints into out), for
// the wrapper's mirror to be checked against on the card.
extern "C" int bfft_k1_plan(int nx, int ny, int nz, int is_f64, void* out) {
  bfft::k1_plan(nx, ny, nz, is_f64 ? 16 : 8, static_cast<int*>(out));
  return 0;
}
