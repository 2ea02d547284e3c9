// K9 for Hopper: the half-spectrum main block of the ds engine, the three
// per-node contractions (y, x, half-z) of boltzfft_torch/ds_operator.py's
// _g_main_half in one launch.
//
// Replaces boltzfft/oz.py::_gmain3_kernel (gmain3_nodemat).  Per node c:
//   stage 1: the shared merged preslice of the (Nx, Nz/2, Ny) spectrum
//            (K7's output) against m_y[c], rows (Nx, Nz/2), K = Ny;
//   stage 2: rows (Ny, Nz/2), K = Nx, against m_x[c];
//   stage 3: rows (Nx, Ny), K = Nz/2, against m_zh[c], real output (Nx, Ny, Nz).
// Every stage is K8's merged contraction (the same device function,
// oz_common.cuh), and the stage outputs are written straight into the next
// stage's row layout, so the result is bitwise equal to the staged K8 chain
// with its transposes.
//
// What bounds it on this card: operations, as K8 (the chunk dots on the
// CUDA cores).  On the TPU a node's whole live set sits in VMEM (~178 B per
// cell).  A CTA here has at most 227 KB of shared memory, so one block per
// node walks each stage in row tiles through shared memory and keeps the two
// intermediates (4 float32 planes each, 8 * Nx*Ny*Nz/2 floats per node) in a
// global scratch buffer, which stays in the 50 MB L2 at 32^3 (24 nodes: 12.6
// MB).  __syncthreads() between the stages orders the block's global writes
// before its reads.  One block per node leaves most SMs idle at 32^3 (24
// nodes): splitting a node across blocks is perf work.
//
// The entry point returns cudaGetLastError() of its launch; it launches on
// the given stream, does not synchronise and allocates nothing.

#include "oz_common.cuh"

namespace {

using bfft_oz::OzTile;

constexpr int kThreads = 512;

struct G3Args {
  const uint16_t* pre;  // (Nx*Nzh, sx*2*Ny)
  const uint16_t *myr, *myi, *mxr, *mxi, *mzr, *mzi;
  float* scratch;       // (C, 8, Nx*Ny*Nzh)
  float *orh, *orl;     // (C, Nx, Ny, Nz)
  int nx, ny, nz, sm, sx, w, fold_tail;
};

__device__ int rows_per_tile(int L) { return L >= kThreads ? 1 : kThreads / L; }

template <int NLEV>
__device__ void stage(OzTile t, int rows, float* smem) {
  t.tr_rows = rows_per_tile(t.L) < rows ? rows_per_tile(t.L) : rows;
  for (int r0 = 0; r0 < rows; r0 += t.tr_rows) {
    t.row0 = r0;
    t.nrows = min(t.tr_rows, rows - r0);
    bfft_oz::oz_tile<NLEV>(t, smem);
  }
}

template <int NLEV>
__global__ void __launch_bounds__(kThreads) gmain3_kernel(const G3Args a) {
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.x;
  const int nx = a.nx, ny = a.ny, nz = a.nz, nzh = a.nz / 2;
  const long long vol = (long long)nx * ny * nzh;
  float* t1 = a.scratch + (long long)c * 8 * vol;  // (Ny, Nzh, Nx) x 4 planes
  float* t2 = t1 + 4 * vol;                         // (Nx, Ny, Nzh) x 4 planes
  OzTile t;
  t.sm = a.sm;
  t.sx = a.sx;
  t.w = a.w;
  t.fold_tail = a.fold_tail;
  t.merged = 1;

  // stage 1 (y): rows (jx, jzh), col jy -> t1[(jy*Nzh + jzh)*Nx + jx]
  t.rh = t.rl = t.ih = t.il = nullptr;
  t.pre0 = a.pre;
  t.pre1 = nullptr;
  t.mre = a.myr + (size_t)c * a.sm * ny * ny;
  t.mim = a.myi + (size_t)c * a.sm * ny * ny;
  t.orh = t1;
  t.orl = t1 + vol;
  t.oih = t1 + 2 * vol;
  t.oil = t1 + 3 * vol;
  t.K = ny;
  t.L = ny;
  t.B = nzh;
  t.sa = 1;
  t.sb = nx;
  t.sl = (long long)nzh * nx;
  stage<NLEV>(t, nx * nzh, smem);
  __syncthreads();

  // stage 2 (x): rows (jy, jzh), K = Nx, col jx -> t2[(jx*Ny + jy)*Nzh + jzh]
  t.pre0 = nullptr;
  t.rh = t1;
  t.rl = t1 + vol;
  t.ih = t1 + 2 * vol;
  t.il = t1 + 3 * vol;
  t.mre = a.mxr + (size_t)c * a.sm * nx * nx;
  t.mim = a.mxi + (size_t)c * a.sm * nx * nx;
  t.orh = t2;
  t.orl = t2 + vol;
  t.oih = t2 + 2 * vol;
  t.oil = t2 + 3 * vol;
  t.K = nx;
  t.L = nx;
  t.B = nzh;
  t.sa = nzh;
  t.sb = 1;
  t.sl = (long long)ny * nzh;
  stage<NLEV>(t, ny * nzh, smem);
  __syncthreads();

  // stage 3 (half z, real output): rows (jx, jy), K = Nzh, col jz
  t.rh = t2;
  t.rl = t2 + vol;
  t.ih = t2 + 2 * vol;
  t.il = t2 + 3 * vol;
  t.mre = a.mzr + (size_t)c * a.sm * nzh * nz;
  t.mim = a.mzi + (size_t)c * a.sm * nzh * nz;
  t.orh = a.orh + (long long)c * nx * ny * nz;
  t.orl = a.orl + (long long)c * nx * ny * nz;
  t.oih = t.oil = nullptr;
  t.K = nzh;
  t.L = nz;
  t.B = 1;
  t.sa = nz;
  t.sb = 0;
  t.sl = 1;
  stage<NLEV>(t, nx * ny, smem);
}

size_t smem_bytes(int nx, int ny, int nz, int sx) {
  size_t b = 0;
  const int dims[3][2] = {{ny, ny}, {nx, nx}, {nz / 2, nz}};  // (K, L) per stage
  for (const auto& d : dims) {
    const int tr = d[1] >= kThreads ? 1 : kThreads / d[1];
    const size_t s = bfft_oz::tile_smem_bytes(d[0], d[1], sx, tr);
    b = s > b ? s : b;
  }
  return b;
}

template <int NLEV>
int launch(const G3Args& a, int n_nodes, cudaStream_t st) {
  const size_t smem = smem_bytes(a.nx, a.ny, a.nz, a.sx);
  cudaError_t err = cudaFuncSetAttribute(
      gmain3_kernel<NLEV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  gmain3_kernel<NLEV><<<n_nodes, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int bfft_oz_gmain3(const void* pre, const void* myr, const void* myi,
                              const void* mxr, const void* mxi, const void* mzr,
                              const void* mzi, void* scratch, void* orh, void* orl,
                              int n_nodes, int nx, int ny, int nz, int sm, int nlev,
                              int sx, int w, int fold_tail, void* stream) {
  if (n_nodes < 1 || nx < 1 || ny < 1 || nz < 2 || nz % 2 || nx > kThreads ||
      ny > kThreads || nz > kThreads || sm < 1 || sm > bfft_oz::SM_MAX || sx < 1 ||
      sx > bfft_oz::SX_MAX || nlev < 1 || nlev > 8)
    return cudaErrorInvalidValue;
  if (smem_bytes(nx, ny, nz, sx) > 232448) return cudaErrorInvalidValue;
  G3Args a;
  a.pre = (const uint16_t*)pre;
  a.myr = (const uint16_t*)myr;
  a.myi = (const uint16_t*)myi;
  a.mxr = (const uint16_t*)mxr;
  a.mxi = (const uint16_t*)mxi;
  a.mzr = (const uint16_t*)mzr;
  a.mzi = (const uint16_t*)mzi;
  a.scratch = (float*)scratch;
  a.orh = (float*)orh;
  a.orl = (float*)orl;
  a.nx = nx;
  a.ny = ny;
  a.nz = nz;
  a.sm = sm;
  a.sx = sx;
  a.w = w;
  a.fold_tail = fold_tail;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (nlev) {
    case 1: return launch<1>(a, n_nodes, st);
    case 2: return launch<2>(a, n_nodes, st);
    case 3: return launch<3>(a, n_nodes, st);
    case 4: return launch<4>(a, n_nodes, st);
    case 5: return launch<5>(a, n_nodes, st);
    case 6: return launch<6>(a, n_nodes, st);
    case 7: return launch<7>(a, n_nodes, st);
    default: return launch<8>(a, n_nodes, st);
  }
}
