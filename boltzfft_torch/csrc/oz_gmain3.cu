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
// What bounds it on this card: operations, as K8: the chunk dots, on the
// tensor cores through the shared tile (oz_common.cuh oz_tile), then the
// fold on the CUDA cores.  On the TPU a node's whole live set sits in VMEM
// (~178 B per cell).  A CTA here has at most 227 KB of shared memory, so
// each stage is walked in row tiles through shared memory and the two
// intermediates (4 float32 planes each, 8 * Nx*Ny*Nz/2 floats per node)
// live in a global scratch buffer, which stays in the 50 MB L2 at 32^3 (24
// nodes: 12.6 MB).
//
// What the design does about it: one thread-block cluster of kCluster CTAs
// per node (grid C * kCluster, 192 CTAs at 32^3 on 132 SMs).  The row
// partition, the one place it is stated (kernels/oz_gmain.py
// cluster_partition mirrors it): stage s of R rows is cut into tiles of the
// rows oz_common.cuh oz_plan gives it; CTA `rank` of the cluster takes
// tiles rank, rank + kCluster, rank + 2 kCluster, ... (of every column
// group), with the stage's slices loaded once.  The share is fixed, so the
// result does not depend on scheduling.  Between the stages a
// __threadfence() and the cluster barrier (barrier.cluster arrive.release /
// wait.acquire) order each CTA's global writes before the next stage's
// reads by the cluster's other CTAs.
//
// The entry point returns cudaGetLastError() of its launch; it launches on
// the given stream, does not synchronise and allocates nothing.

#include <cooperative_groups.h>

#include "oz_common.cuh"

namespace {

using bfft_oz::OzTile;

constexpr int kCluster = 8;  // CTAs per node: the portable cluster size

struct G3Args {
  const uint16_t* pre;  // (Nx*Nzh, sx*2*Ny)
  const uint16_t *myr, *myi, *mxr, *mxi, *mzr, *mzi;
  float* scratch;       // (C, 8, Nx*Ny*Nzh)
  float *orh, *orl;     // (C, Nx, Ny, Nz)
  int nx, ny, nz, sm, sx, w, fold_tail, nsl, nlev;
};

// The stage's writes, visible to the cluster's other CTAs before they read.
__device__ __forceinline__ void cluster_barrier() {
  __threadfence();
  cooperative_groups::this_cluster().sync();
}

// Two blocks an SM: at most 128 registers a thread (nvcc gives it ~230
// otherwise, one block an SM).
__global__ void __launch_bounds__(bfft_oz::OZ_THREADS, 2) gmain3_kernel(const G3Args a) {
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.x / kCluster;
  const int rank = (int)cooperative_groups::this_cluster().block_rank();
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
  t.nsl = a.nsl;
  t.nlev = a.nlev;
  // one call site of the tile for the three stages (it is inlined)
  for (int s = 0; s < 3; ++s) {
    int rows;
    if (s == 0) {
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
      rows = nx * nzh;
    } else if (s == 1) {
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
      rows = ny * nzh;
    } else {
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
      rows = nx * ny;
    }
    // this CTA's share: tiles rank, rank + kCluster, ...
    bfft_oz::oz_stage(t, rows, rank, kCluster, 0, 1, smem, 0);
    if (s < 2) cluster_barrier();
  }
}

size_t smem_bytes(int nx, int ny, int nz, int sx, int nsl) {
  size_t b = 0;
  const int nzh = nz / 2;
  const int dims[3][3] = {{ny, ny, nx * nzh}, {nx, nx, ny * nzh}, {nzh, nz, nx * ny}};  // K, L, rows
  for (const auto& d : dims) {
    const bfft_oz::OzPlan p = bfft_oz::oz_plan(d[0], d[1], sx, nsl, d[2], 0);
    const size_t s = bfft_oz::tile_smem_bytes(d[0], p.lg, sx, p.tr, nsl);
    b = s > b ? s : b;
  }
  return b;
}

int launch(const G3Args& a, int n_nodes, cudaStream_t st) {
  const size_t smem = smem_bytes(a.nx, a.ny, a.nz, a.sx, a.nsl);
  cudaError_t err = cudaFuncSetAttribute(
      gmain3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_nodes * kCluster);
  cfg.blockDim = dim3(bfft_oz::OZ_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gmain3_kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" int bfft_oz_gmain3(const void* pre, const void* myr, const void* myi,
                              const void* mxr, const void* mxi, const void* mzr,
                              const void* mzi, void* scratch, void* orh, void* orl,
                              int n_nodes, int nx, int ny, int nz, int sm, int nlev,
                              int sx, int w, int fold_tail, void* stream) {
  if (n_nodes < 1 || nx < 1 || ny < 1 || nz < 2 || nz % 2 || sm < 1 ||
      sm > bfft_oz::SM_MAX || sx < 1 ||
      sx > bfft_oz::SX_MAX || nlev < 1 || nlev > 8)
    return cudaErrorInvalidValue;
  const int nsl = sm < nlev ? sm : nlev;
  if (smem_bytes(nx, ny, nz, sx, nsl) > bfft_oz::OZ_SMEM_MAX) return cudaErrorInvalidValue;
  G3Args a;
  a.nsl = nsl;
  a.nlev = nlev;
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
  return launch(a, n_nodes, st);
}
