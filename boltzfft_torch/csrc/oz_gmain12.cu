// K10 for Hopper: the y and x main-block contractions of the ds engine's
// half-spectrum streams fused, per (node, z-half block), in one launch; the
// half-z stage stays a staged K8 call (boltzfft_torch/ds_operator.py
// _g_main_half with fused="12").
//
// Replaces boltzfft/oz.py::_gmain12_kernel (gmain12_nodemat).  Block
// (zblk, c) takes the z-half rows z0 = zblk * zb .. z0 + zb - 1 of node c:
//   stage 1: the shared merged preslice of the (Nx, Nz/2, Ny) spectrum
//            (K7's output), rows (jx, z0 + dz), K = Ny, against m_y[c];
//   stage 2: rows (jy, z0 + dz), K = Nx, against m_x[c], written straight
//            into the (C, Nx, Ny, Nz/2) layout the half-z K8 call reads.
// Both stages are K8's merged contraction (the same device function,
// oz_common.cuh); z is a passenger of both, rows are independent, so the
// result is bitwise equal to the staged K8 chain for every z block.
//
// What bounds it on this card: operations, as K8: the chunk dots, on the
// tensor cores through the shared tile (oz_common.cuh oz_tile), then the
// fold on the CUDA cores.  The TPU kernel keeps the stage-1 intermediate in
// VMEM; here it stays in the block's shared memory (4 float32 planes of
// Nx * zb * Ny values: 16 KB at 32^3 and 64 KB at 64^3 for zb = 1) beside
// the tile buffers (the stages' slices, loaded once per stage, and the
// tile's chunks, oz_common.cuh oz_plan sizing them beside it), so it never
// reaches device memory.  The z blocking is what gives the card
// parallelism: C * Nz/(2 zb) blocks.  The block's z
// extent is chosen by boltzfft_torch/oz.py default_zh_block (the fewest z
// rows that fill a 512-thread tile of the CUDA-core tile this kernel had
// before, among those whose block fits in shared memory,
// bfft_oz_gmain12_fits, the one count of it): 1 at 32^3 and 64^3.
//
// The entry point returns cudaGetLastError() of its launch; it launches on
// the given stream, does not synchronise and allocates nothing.

#include "oz_common.cuh"

namespace {

using bfft_oz::OzTile;

struct G12Args {
  const uint16_t* pre;  // (Nx*Nzh, sx*2*Ny)
  const uint16_t *myr, *myi, *mxr, *mxi;  // (C, sm, N, N)
  float *orh, *orl, *oih, *oil;           // (C, Nx, Ny, Nzh)
  int nx, ny, nzh, zb, sm, sx, w, fold_tail, nsl, nlev;
};

__global__ void __launch_bounds__(bfft_oz::OZ_THREADS) gmain12_kernel(const G12Args a) {
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.y;
  const int z0 = blockIdx.x * a.zb;
  const int nx = a.nx, ny = a.ny, nzh = a.nzh, zb = a.zb;
  const int vb = nx * zb * ny;  // one plane of the block's intermediate
  float* s_t = smem;            // (Ny, zb, Nx) x 4 planes
  float* tile = smem + 4 * vb;  // 16-byte aligned: vb floats per plane, 4 planes
  OzTile t;
  t.sm = a.sm;
  t.sx = a.sx;
  t.w = a.w;
  t.fold_tail = a.fold_tail;
  t.merged = 1;
  t.nsl = a.nsl;
  t.nlev = a.nlev;
  const size_t inter = sizeof(float) * 4 * (size_t)vb;
  // one call site of the tile for the two stages (it is inlined)
  for (int s = 0; s < 2; ++s) {
    int rows;
    if (s == 0) {
      // stage 1 (y): row r = jx*zb + dz reads preslice row jx*Nzh + z0 + dz;
      // column jy -> s_t[(jy*zb + dz)*Nx + jx]
      t.rh = t.rl = t.ih = t.il = nullptr;
      t.pre0 = a.pre + (size_t)z0 * (2 * a.sx * ny);
      t.pre1 = nullptr;
      t.iB = zb;
      t.isa = nzh;
      t.isb = 1;
      t.mre = a.myr + (size_t)c * a.sm * ny * ny;
      t.mim = a.myi + (size_t)c * a.sm * ny * ny;
      t.orh = s_t;
      t.orl = s_t + vb;
      t.oih = s_t + 2 * vb;
      t.oil = s_t + 3 * vb;
      t.K = ny;
      t.L = ny;
      t.B = zb;
      t.sa = 1;
      t.sb = nx;
      t.sl = (long long)zb * nx;
      rows = nx * zb;
    } else {
      // stage 2 (x): rows (jy, dz), K = Nx, from shared memory (the barriers
      // of load_slices and oz_tile order stage 1's writes before these
      // reads); column jx -> out[c, jx, jy, z0 + dz]
      const long long obase = (long long)c * nx * ny * nzh + z0;
      t.pre0 = nullptr;
      t.rh = s_t;
      t.rl = s_t + vb;
      t.ih = s_t + 2 * vb;
      t.il = s_t + 3 * vb;
      t.iB = 1;
      t.isa = 1;
      t.isb = 0;
      t.mre = a.mxr + (size_t)c * a.sm * nx * nx;
      t.mim = a.mxi + (size_t)c * a.sm * nx * nx;
      t.orh = a.orh + obase;
      t.orl = a.orl + obase;
      t.oih = a.oih + obase;
      t.oil = a.oil + obase;
      t.K = nx;
      t.L = nx;
      t.B = zb;
      t.sa = nzh;
      t.sb = 1;
      t.sl = (long long)ny * nzh;
      rows = ny * zb;
    }
    bfft_oz::oz_stage(t, rows, 0, 1, 0, 1, tile, inter);
  }
}

// The block's shared memory: the stage-1 intermediate, then the larger of
// its two stages' tiles, each planned beside the intermediate.
size_t smem_bytes(int nx, int ny, int zb, int sx, int nsl) {
  const size_t inter = sizeof(float) * 4 * (size_t)nx * zb * ny;
  const int dims[2][2] = {{ny, nx * zb}, {nx, ny * zb}};  // (K = L, rows) per stage
  size_t b = 0;
  for (const auto& d : dims) {
    const bfft_oz::OzPlan p = bfft_oz::oz_plan(d[0], d[0], sx, nsl, d[1], inter);
    const size_t s = bfft_oz::tile_smem_bytes(d[0], p.lg, sx, p.tr, nsl);
    b = s > b ? s : b;
  }
  return inter + b;
}

int launch(const G12Args& a, int n_nodes, cudaStream_t st) {
  const size_t smem = smem_bytes(a.nx, a.ny, a.zb, a.sx, a.nsl);
  cudaError_t err = cudaFuncSetAttribute(
      gmain12_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  gmain12_kernel<<<dim3(a.nzh / a.zb, n_nodes), bfft_oz::OZ_THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// 1 when a block of z extent zb (its stage-1 intermediate and the larger of
// its two stages' tiles, nsl matrix slices kept) fits in a block's shared
// memory, else 0.
extern "C" int bfft_oz_gmain12_fits(int nx, int ny, int zb, int sx, int nsl) {
  if (nx < 1 || ny < 1 || zb < 1 || sx < 1 || nsl < 1) return 0;
  return smem_bytes(nx, ny, zb, sx, nsl) <= bfft_oz::OZ_SMEM_MAX ? 1 : 0;
}

extern "C" int bfft_oz_gmain12(const void* pre, const void* myr, const void* myi,
                               const void* mxr, const void* mxi, void* orh, void* orl,
                               void* oih, void* oil, int n_nodes, int nx, int ny, int nzh,
                               int zb, int sm, int nlev, int sx, int w, int fold_tail,
                               void* stream) {
  if (n_nodes < 1 || n_nodes > 65535 || nx < 1 || ny < 1 || nzh < 1 || zb < 1 ||
      nzh % zb || sm < 1 || sm > bfft_oz::SM_MAX ||
      sx < 1 || sx > bfft_oz::SX_MAX || nlev < 1 || nlev > 8)
    return cudaErrorInvalidValue;
  const int nsl = sm < nlev ? sm : nlev;
  if (!bfft_oz_gmain12_fits(nx, ny, zb, sx, nsl)) return cudaErrorInvalidValue;
  G12Args a;
  a.nsl = nsl;
  a.nlev = nlev;
  a.pre = (const uint16_t*)pre;
  a.myr = (const uint16_t*)myr;
  a.myi = (const uint16_t*)myi;
  a.mxr = (const uint16_t*)mxr;
  a.mxi = (const uint16_t*)mxi;
  a.orh = (float*)orh;
  a.orl = (float*)orl;
  a.oih = (float*)oih;
  a.oil = (float*)oil;
  a.nx = nx;
  a.ny = ny;
  a.nzh = nzh;
  a.zb = zb;
  a.sm = sm;
  a.sx = sx;
  a.w = w;
  a.fold_tail = fold_tail;
  const cudaStream_t st = (cudaStream_t)stream;
  return launch(a, n_nodes, st);
}
