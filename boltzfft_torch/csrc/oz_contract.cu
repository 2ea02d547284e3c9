// K8 for Hopper: the Ozaki-sliced double-single contraction of the last axis,
// out[..., l] = sum_k x[..., k] m[k, l], float32 pairs in and out.
//
// Replaces boltzfft/oz.py::_oz_contract_kernel_v3 as launched by
// contract_last_oz_kernel (a shared matrix; real_in, real_out),
// _phased_contract (a shared matrix, a ds phase row per node applied to x in
// the tile load, conj or not; x shared by every node with repeat, else one
// x per node) and contract_last_oz_nodemat (per-node matrices; repeat,
// presliced input, merged, real_out).
//
// What bounds it on this card: operations.  Per output element it does
// (levels' chunk pairs) x K multiply-adds per component pair: at cmax = 6,
// 28 pairs; at 64^3 a per-node stage is ~1 GMAC.  The chunk dots are exact
// bf16 products, so they run on the tensor cores (oz_common.cuh oz_tile:
// mma.sync m16n8k16, each k16 step into a zeroed fragment, float32 adds
// per level); the bound is their bf16 rate plus the fold's float32
// arithmetic on the CUDA cores.  What is left on the CUDA cores: the chunk
// cut (or a copy of K7's presliced chunks), the per-step level adds and the
// fold, and what limits the mma.sync rate here is shared memory: each
// product reads its A and B fragments (768 bytes) afresh.
//
// What the design does about it: a block (OZ_THREADS threads) loads the
// node's matrix slices once into shared memory (cp.async; a column group
// of them where all do not fit, oz_common.cuh oz_plan) and walks row tiles
// of that node (blocks x, x + gridDim.x, ...; as many blocks as fill the
// card once).  Per tile it cuts the chunks into shared memory as bf16, then
// each warp forms its 16 x 8 output tiles' level lists level by level,
// folding each level as it is formed in the TPU kernel's order, with no
// barrier.  The per-node matrices (or phase rows) are selected by
// blockIdx.y; a shared operand (repeat) is read in place for every node.
// Phased mode adds ~120 float operations per operand element (four ds
// products and two ds adds, the TPU kernel's order), done twice, for the
// row maximum and for the chunks, rather than staged.  No atomics touch the
// result; every level sum is exact whatever its order, and every fold runs
// in one thread in a fixed order, so the result is bitwise reproducible
// and equal to the plain PyTorch version.
//
// The entry point returns cudaGetLastError() of its launch; it launches on
// the given stream, does not synchronise and allocates nothing.

#include "oz_common.cuh"

namespace {

using bfft_oz::OzTile;

struct OzArgs {
  const float *rh, *rl, *ih, *il;
  const uint16_t *pre0, *pre1, *mre, *mim;
  const float *prh, *prl, *pih, *pil;  // (n_nodes, K) phase rows, or null
  float *orh, *orl, *oih, *oil;
  int rows_pn, per_node, x_per_node, K, L, sm, sx, w, fold_tail, merged, conj, nsl, nlev;
};

// Block (x, node, group): the row tiles x, x + gridDim.x, ... of one node,
// in the column group blockIdx.z, whose slices it loads once.
__global__ void __launch_bounds__(bfft_oz::OZ_THREADS) oz_contract_kernel(const OzArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int node = blockIdx.y;
  OzTile t;
  const long long xrow = a.x_per_node ? (long long)node * a.rows_pn : 0;
  const long long xoff = xrow * a.K;
  t.rh = a.rh ? a.rh + xoff : nullptr;
  t.rl = a.rl ? a.rl + xoff : nullptr;
  t.ih = a.ih ? a.ih + xoff : nullptr;
  t.il = a.il ? a.il + xoff : nullptr;
  const long long pw = (long long)a.sx * a.K * (a.merged ? 2 : 1);
  t.pre0 = a.pre0 ? a.pre0 + xrow * pw : nullptr;
  t.pre1 = a.pre1 ? a.pre1 + xrow * pw : nullptr;
  const size_t moff = a.per_node ? (size_t)node * a.sm * a.K * a.L : 0;
  t.mre = a.mre + moff;
  t.mim = a.mim + moff;
  if (a.prh != nullptr) {
    const long long poff = (long long)node * a.K;
    t.prh = a.prh + poff;
    t.prl = a.prl + poff;
    t.pih = a.pih + poff;
    t.pil = a.pil + poff;
    t.conj = a.conj;
  }
  const long long ooff = (long long)node * a.rows_pn * a.L;
  t.orh = a.orh + ooff;
  t.orl = a.orl + ooff;
  t.oih = a.oih ? a.oih + ooff : nullptr;
  t.oil = a.oil ? a.oil + ooff : nullptr;
  t.K = a.K;
  t.L = a.L;
  t.sm = a.sm;
  t.sx = a.sx;
  t.w = a.w;
  t.fold_tail = a.fold_tail;
  t.merged = a.merged;
  t.nsl = a.nsl;
  t.nlev = a.nlev;
  t.B = 1;
  t.sa = a.L;
  t.sb = 0;
  t.sl = 1;
  bfft_oz::oz_stage(t, a.rows_pn, blockIdx.x, gridDim.x, blockIdx.z, gridDim.z, smem, 0);
}

int launch(const OzArgs& a, int n_nodes, cudaStream_t st) {
  const bfft_oz::OzPlan p = bfft_oz::oz_plan(a.K, a.L, a.sx, a.nsl, a.rows_pn, 0);
  const size_t smem = bfft_oz::tile_smem_bytes(a.K, p.lg, a.sx, p.tr, a.nsl);
  cudaError_t err = cudaFuncSetAttribute(
      oz_contract_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // enough blocks to fill the card once: each walks the row tiles of its
  // node and column group, loading their slices once
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, oz_contract_kernel,
                                                           bfft_oz::OZ_THREADS, smem)) != cudaSuccess)
    return err;
  const int groups = (a.L + p.lg - 1) / p.lg;
  const int n_tiles = (a.rows_pn + p.tr - 1) / p.tr;
  const long long want = ((long long)sms * (per_sm > 0 ? per_sm : 1) + n_nodes * groups - 1)
                         / ((long long)n_nodes * groups);
  const int row_blocks = (int)(want < n_tiles ? (want > 0 ? want : 1) : n_tiles);
  const dim3 grid(row_blocks, n_nodes, groups);
  oz_contract_kernel<<<grid, bfft_oz::OZ_THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// flags: 1 real_in, 2 real_out, 4 merged, 8 presliced (pre0/pre1 given),
// 16 conj; phased mode when prh is given (complex planes in, unmerged)
extern "C" int bfft_oz_contract(const void* rh, const void* rl, const void* ih,
                                const void* il, const void* pre0, const void* pre1,
                                const void* mre, const void* mim, const void* prh,
                                const void* prl, const void* pih, const void* pil,
                                void* orh, void* orl,
                                void* oih, void* oil, int n_nodes, int rows_pn,
                                int per_node, int x_per_node, int K, int L, int sm,
                                int nlev, int sx, int w, int fold_tail, int flags,
                                void* stream) {
  if (n_nodes < 1 || n_nodes > 65535 || rows_pn < 1 || K < 1 || L < 1 ||
      sm < 1 || sm > bfft_oz::SM_MAX || sx < 1 || sx > bfft_oz::SX_MAX || nlev < 1 || nlev > 8)
    return cudaErrorInvalidValue;
  OzArgs a;
  const bool presliced = flags & 8;
  const bool real_in = flags & 1, real_out = flags & 2;
  const bool phased = prh != nullptr;
  if (phased && (presliced || real_in || (flags & 4) || per_node || !prl || !pih || !pil))
    return cudaErrorInvalidValue;
  a.rh = presliced ? nullptr : (const float*)rh;
  a.rl = presliced ? nullptr : (const float*)rl;
  a.ih = presliced || real_in ? nullptr : (const float*)ih;
  a.il = presliced || real_in ? nullptr : (const float*)il;
  a.pre0 = presliced ? (const uint16_t*)pre0 : nullptr;
  a.pre1 = presliced ? (const uint16_t*)pre1 : nullptr;
  a.mre = (const uint16_t*)mre;
  a.mim = (const uint16_t*)mim;
  a.prh = (const float*)prh;
  a.prl = (const float*)prl;
  a.pih = (const float*)pih;
  a.pil = (const float*)pil;
  a.conj = (flags & 16) ? 1 : 0;
  a.orh = (float*)orh;
  a.orl = (float*)orl;
  a.oih = real_out ? nullptr : (float*)oih;
  a.oil = real_out ? nullptr : (float*)oil;
  a.rows_pn = rows_pn;
  a.per_node = per_node;
  a.x_per_node = x_per_node;
  a.K = K;
  a.L = L;
  a.sm = sm;
  a.sx = sx;
  a.w = w;
  a.fold_tail = fold_tail;
  a.merged = (flags & 4) ? 1 : 0;
  a.nsl = sm < nlev ? sm : nlev;
  a.nlev = nlev;
  const bfft_oz::OzPlan p = bfft_oz::oz_plan(K, L, sx, a.nsl, rows_pn, 0);
  if (bfft_oz::tile_smem_bytes(K, p.lg, sx, p.tr, a.nsl) > bfft_oz::OZ_SMEM_MAX)
    return cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return launch(a, n_nodes, st);
}
