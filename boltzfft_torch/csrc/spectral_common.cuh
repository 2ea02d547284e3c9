// Device code shared by the port's kernels (fused_collide.cu: K1,
// fused_gain_kron.cu: K3): complex helpers, the generic axis-DFT kernel, the
// real group sum and the ordered beta1 accumulation.
//
// All arithmetic is IEEE float/double fma on the CUDA cores, and every
// reduction runs inside one thread in a fixed order (no float atomics), so
// results are bitwise reproducible and independent of the batch size.

#pragma once

#include <cuda_runtime.h>

#include <algorithm>

namespace bfft {

constexpr int kTile = 32;    // lines per axis-DFT block: one per lane
constexpr int kRows = 8;     // axis-DFT outputs per thread per pass
constexpr int kThreads = 256;

template <typename T> struct Cplx;
template <> struct Cplx<float> { using type = float2; };
template <> struct Cplx<double> { using type = double2; };

__device__ __forceinline__ float dev_sin(float x) { return sinf(x); }
__device__ __forceinline__ double dev_sin(double x) { return sin(x); }
__device__ __forceinline__ float dev_fma(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double dev_fma(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename C2>
__device__ __forceinline__ C2 cmul(C2 a, C2 b) {
  C2 r;
  r.x = a.x * b.x - a.y * b.y;
  r.y = a.x * b.y + a.y * b.x;
  return r;
}

// acc += a * x as four fmas (the complex multiply-add of every contraction)
template <typename C2>
__device__ __forceinline__ void cmac(C2& acc, C2 a, C2 x) {
  acc.x = dev_fma(a.x, x.x, acc.x);
  acc.x = dev_fma(-a.y, x.y, acc.x);
  acc.y = dev_fma(a.x, x.y, acc.y);
  acc.y = dev_fma(a.y, x.x, acc.y);
}

// The phase of batch entry j: row (j >> 1) % phase_rows of the table,
// conjugated for odd j (the g1/g2 stream pair); (1, 0) without a table.
template <typename C2>
__device__ __forceinline__ C2 stream_phase(const C2* phase, int phase_rows,
                                           long long j, int n, int m) {
  C2 p;
  p.x = 1;
  p.y = 0;
  if (phase != nullptr) {
    p = phase[((j >> 1) % phase_rows) * n + m];
    if (j & 1) p.y = -p.y;
  }
  return p;
}

// out[j][a, i, c] = sum_m mat[i, m] * ph_j[m] * in[j / in_div][a, m, c]
//
// The grid is (A, n, C) row-major around the transformed axis; a "line" is one
// (a, c) pair, n_lines = A * C.  blockIdx.x runs over n_tiles tiles of kTile
// lines for each batch entry j (j-major), so the batch is not bound by the
// 65535 limit of gridDim.y.  ph_j is stream_phase(phase, phase_rows, j).
template <typename T, bool kRealIn>
__global__ void __launch_bounds__(kThreads) axis_dft_kernel(
    const void* __restrict__ in_raw, long long in_grid, int in_div,
    typename Cplx<T>::type* __restrict__ out, int n_lines, int n_tiles, int n,
    int c, const typename Cplx<T>::type* __restrict__ mat,
    const typename Cplx<T>::type* __restrict__ phase, int phase_rows) {
  using C2 = typename Cplx<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C2* sm_mat = reinterpret_cast<C2*>(smem_raw);
  C2* sm_x = sm_mat + n * n;
  constexpr int ld = kTile + 1;  // padded row: conflict-free column stores

  const long long j = blockIdx.x / n_tiles;
  const int l0 = (blockIdx.x % n_tiles) * kTile;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  for (int k = tid; k < n * n; k += nthreads) sm_mat[k] = mat[k];

  const long long in_base = (j / in_div) * in_grid;
  for (int k = tid; k < kTile * n; k += nthreads) {
    // consecutive k -> consecutive addresses: along m when c == 1 (the
    // contiguous axis), along the lines otherwise
    int lt, m;
    if (c == 1) {
      lt = k / n;
      m = k % n;
    } else {
      m = k / kTile;
      lt = k % kTile;
    }
    const int l = l0 + lt;
    C2 v;
    v.x = 0;
    v.y = 0;
    if (l < n_lines) {
      const long long off =
          in_base + (long long)(l / c) * n * c + (long long)m * c + (l % c);
      if (kRealIn) {
        v.x = reinterpret_cast<const T*>(in_raw)[off];
      } else {
        v = reinterpret_cast<const C2*>(in_raw)[off];
      }
      if (phase != nullptr) v = cmul(stream_phase(phase, phase_rows, j, n, m), v);
    }
    sm_x[m * ld + lt] = v;
  }
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const int l = l0 + lane;
  const bool valid = l < n_lines;
  const long long grid_elems = (long long)n_lines * n;
  const long long out_base =
      j * grid_elems + (long long)(l / c) * n * c + (l % c);

  for (int i0 = warp * kRows; i0 < n; i0 += nwarps * kRows) {
    C2 acc[kRows];
    int row[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      acc[r].x = 0;
      acc[r].y = 0;
      row[r] = min(i0 + r, n - 1) * n;
    }
    for (int m = 0; m < n; ++m) {
      const C2 x = sm_x[m * ld + lane];
#pragma unroll
      for (int r = 0; r < kRows; ++r) cmac(acc[r], sm_mat[row[r] + m], x);
    }
    if (valid) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (i0 + r < n) out[out_base + (long long)(i0 + r) * c] = acc[r];
      }
    }
  }
}

// One axis-DFT launch over nbatch grids of shape (A, n, c).
template <typename T, bool kRealIn>
cudaError_t axis_dft(const void* in, long long in_grid, int in_div,
                     typename Cplx<T>::type* out, long long nbatch, int a,
                     int n, int c, const typename Cplx<T>::type* mat,
                     const typename Cplx<T>::type* phase, int phase_rows,
                     cudaStream_t st) {
  using C2 = typename Cplx<T>::type;
  const int n_lines = a * c;
  const int n_tiles = (n_lines + kTile - 1) / kTile;
  const int nwarps = std::min(kThreads / 32, (n + kRows - 1) / kRows);
  const size_t smem = (size_t)n * n * sizeof(C2) +
                      (size_t)n * (kTile + 1) * sizeof(C2);
  if (nbatch * n_tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      axis_dft_kernel<T, kRealIn>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  axis_dft_kernel<T, kRealIn>
      <<<(unsigned)(nbatch * n_tiles), nwarps * 32, smem, st>>>(
          in, in_grid, in_div, out, n_lines, n_tiles, n, c, mat, phase,
          phase_rows);
  return cudaGetLastError();
}

// s[e, g] = sum_{b in group g} w_b (Re g1_b Re g2_b - Im g1_b Im g2_b), nodes
// in order; the streams are laid out j = ((e * n_nodes) + b) * 2 + {0, 1}.
template <typename T>
__global__ void group_sum_kernel(const typename Cplx<T>::type* __restrict__ g,
                                 const T* __restrict__ w, T* __restrict__ s,
                                 long long n3, int n_nodes, int gs,
                                 int n_groups) {
  using C2 = typename Cplx<T>::type;
  const long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (p >= n3) return;
  const int eg = blockIdx.y;
  const int e = eg / n_groups;
  const int b0 = (eg % n_groups) * gs;
  const int b1 = min(b0 + gs, n_nodes);
  T acc = 0;
  for (int b = b0; b < b1; ++b) {
    const long long jj = ((long long)e * n_nodes + b) * 2;
    const C2 g1 = g[jj * n3 + p];
    const C2 g2 = g[(jj + 1) * n3 + p];
    acc = acc + w[b] * (g1.x * g2.x - g1.y * g2.y);
  }
  s[eg * n3 + p] = acc;
}

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
