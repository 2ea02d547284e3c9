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
// 28 pairs; at 64^3 a per-node stage is ~1 GFMA.  On the TPU the chunk dots
// run on the MXU in bf16; here they run as float32 FMAs on the CUDA cores,
// which are exact for these values, so the arithmetic is right but the rate
// is the CUDA cores' (a tensor-core version is perf work, ROADMAP).
//
// What the design does about it: one block holds a tile of rows and every
// output column; it cuts the tile's chunks once into shared memory (or reads
// K7's presliced chunks), then streams the matrix slices through shared
// memory one at a time, each thread forming all levels of its output in
// registers with float4 loads along K, and folding them in the TPU kernel's
// order.  The per-node matrices (or phase rows) are selected by blockIdx.y;
// a shared operand (repeat) is read in place for every node.  Phased mode
// adds ~120 float operations per operand element (four ds products and two
// ds adds, the TPU kernel's order), done twice, for the row maximum and for
// the chunks, rather than staged: a few percent of the contraction's
// chunk-pair arithmetic at K = 32-64.  No atomics touch the result;
// every sum runs in one thread in a fixed order, so the result is bitwise
// reproducible and equal to the plain PyTorch version.
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
  int rows_pn, per_node, x_per_node, K, L, sm, sx, w, fold_tail, merged, conj, tr_rows;
};

template <int NLEV>
__global__ void oz_contract_kernel(const OzArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int node = blockIdx.y;
  const int row0 = blockIdx.x * a.tr_rows;
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
  t.row0 = row0;
  t.nrows = min(a.tr_rows, a.rows_pn - row0);
  t.tr_rows = a.tr_rows;
  t.K = a.K;
  t.L = a.L;
  t.sm = a.sm;
  t.sx = a.sx;
  t.w = a.w;
  t.fold_tail = a.fold_tail;
  t.merged = a.merged;
  t.B = 1;
  t.sa = a.L;
  t.sb = 0;
  t.sl = 1;
  bfft_oz::oz_tile<NLEV>(t, smem);
}

constexpr int kThreads = 512;

template <int NLEV>
int launch(const OzArgs& a, int n_nodes, cudaStream_t st) {
  const size_t smem = bfft_oz::tile_smem_bytes(a.K, a.L, a.sx, a.tr_rows);
  cudaError_t err = cudaFuncSetAttribute(
      oz_contract_kernel<NLEV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.rows_pn + a.tr_rows - 1) / a.tr_rows, n_nodes);
  oz_contract_kernel<NLEV><<<grid, a.tr_rows * a.L, smem, st>>>(a);
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
  if (n_nodes < 1 || n_nodes > 65535 || rows_pn < 1 || K < 1 || L < 1 || L > kThreads ||
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
  a.tr_rows = kThreads / L < rows_pn ? kThreads / L : rows_pn;
  if (bfft_oz::tile_smem_bytes(K, L, sx, a.tr_rows) > 232448) return cudaErrorInvalidValue;
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
