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
// Both stages are K8's merged contraction: the same chunks, the same exact
// tensor-core steps (oz_common.cuh) and the same fold, level by level; z is
// a passenger of both, rows are independent, so the result is bitwise
// equal to the staged K8 chain for every z block.
//
// What bounds it on this card: operations, the chunk dots on the tensor
// cores and the fold on the CUDA cores.  The stage-1 intermediate stays in
// the block's shared memory (4 float32 planes of Nx * zb * Ny values: 64 KB
// at 64^3 for zb = 1) beside the stage's matrix slices and a row tile of
// chunks, so it never reaches device memory.
//
// What the design does about it (the tile K8 and K9 share walks 16 x 16
// output tiles level by level, reloading both fragments of every chunk
// pair; with the 64 KB intermediate beside the slices it fits only 16-row
// tiles at 64^3, which keep 4 of its 8 warps busy):
// - each warp owns a 16 x 8 output tile (one m16n8k16 column) and forms all
//   its levels at once in registers: per k16 step the A fragments of chunk
//   i are loaded once and serve every slice j with i + j < nlev, whose
//   B fragments (re and im) come in one ldmatrix.x4.trans.  Each step is
//   still one product chain from a zeroed fragment, added into its level in
//   float32; those adds are exact (every partial sum of a level is an
//   integer below 2^24 of its unit, oz.merge_ok), so the new order gives
//   the same bits, and the levels are folded in the old order afterwards.
//   The chunk pairs are fixed at compile time (the kernel is instantiated
//   for 7 and 8 levels; chunks past sx and slices past sm are zero in
//   shared memory), so nvcc interleaves their loads and products instead
//   of running each pair behind a branch;
// - an output column of 8 keeps 8 warps busy on a 16-row tile of 64
//   columns (64^3) and on 32 rows of 32 columns (32^3);
// - the stage's slices and the first row tile's chunks are fetched by
//   cp.async together; stage 2's slices arrive while its first tile's
//   chunks are cut from the intermediate; stage 2 takes its row maxima
//   with warp reductions.
// Stage 2 writes one z row at a stride of Nz/2 floats, one 32-byte sector
// a value.  Gathering the output of a cluster of z blocks through
// distributed shared memory, to write along z, measured no faster on the
// H100: clusters of more than 2 such blocks (227 KB of shared memory each)
// do not all fit on the card at once.
//
// The plan, the one count of it (kernels/oz_gmain12.py plan mirrors it):
// per stage the column groups of lg columns (all unless the slices do not
// fit) and row tiles of tr rows (all the stage's rows, halved in multiples
// of 16 until they fit); the shared memory is the intermediate plus the
// larger stage.  The z block zb, unless the caller names one, is the
// largest divisor of Nz/2 whose block fits and which leaves the grid at
// least kMinCtas blocks (C * Nz/(2 zb)), else the smallest that fits.
//
// The entry point returns cudaGetLastError() of its launch; it launches on
// the given stream, does not synchronise and allocates nothing.

#include "oz_common.cuh"

namespace {

using bfft_oz::k_stride;
using bfft_oz::l_stride;
using bfft_oz::padded_k;
using bfft_oz::padded_l;

constexpr int kWarps = bfft_oz::OZ_WARPS;
constexpr int kThreads = bfft_oz::OZ_THREADS;
constexpr int kMaxLev = 8;     // nlev = cmax + 1 <= 8
constexpr int kMinCtas = 264;  // the z-block rule: two blocks for each of the 132 SMs

struct G12Plan {
  int zb, lg[2], tr[2];
  size_t smem;
};

// Shared memory of one stage beside the intermediate: the nsl slices of a
// column group of lg columns (re and im, rows padded to padded_k(K), row
// stride l_stride(lg)), the chunks of tr rows (sx chunks re and im, row
// stride k_stride(K)) and the row maxima.
__host__ __device__ inline size_t stage_bytes(int K, int lg, int sx, int tr, int nsl) {
  return sizeof(uint16_t) * (2 * (size_t)nsl * padded_k(K) * l_stride(lg) +
                             2 * (size_t)sx * tr * k_stride(K)) +
         sizeof(unsigned) * tr;
}

__host__ __device__ inline size_t inter_bytes(int nx, int ny, int zb) {
  return sizeof(float) * 4 * (size_t)nx * ny * zb;
}

G12Plan plan_for(int nx, int ny, int zb, int sx, int nsl) {
  G12Plan p;
  p.zb = zb;
  const size_t inter = inter_bytes(nx, ny, zb);
  const int dims[2][2] = {{ny, nx * zb}, {nx, ny * zb}};  // (K = L, rows) per stage
  size_t most = 0;
  for (int s = 0; s < 2; ++s) {
    const int K = dims[s][0], rows = dims[s][1];
    int lg = K;
    while (lg > 8 && inter + stage_bytes(K, lg, sx, 16, nsl) > bfft_oz::OZ_SMEM_MAX)
      lg = ((lg + 1) / 2 + 7) & ~7;
    int tr = (rows + 15) & ~15;
    while (tr > 16 && inter + stage_bytes(K, lg, sx, tr, nsl) > bfft_oz::OZ_SMEM_MAX)
      tr = (tr / 2 + 15) & ~15;
    p.lg[s] = lg;
    p.tr[s] = tr;
    const size_t b = stage_bytes(K, lg, sx, tr, nsl);
    most = b > most ? b : most;
  }
  p.smem = inter + most;
  return p;
}

bool fits(const G12Plan& p) { return p.smem <= bfft_oz::OZ_SMEM_MAX; }

// The plan for z block zb, or (zb <= 0) for the rule's z block; zb = 0 in
// the result when no block fits.
G12Plan make_plan(int nx, int ny, int nzh, int n_nodes, int sx, int nsl, int zb) {
  if (zb > 0) return plan_for(nx, ny, zb, sx, nsl);
  G12Plan best = {};
  for (int d = 1; d <= nzh; ++d) {
    if (nzh % d) continue;
    const G12Plan p = plan_for(nx, ny, d, sx, nsl);
    if (!fits(p)) continue;
    if (best.zb == 0 || (long long)n_nodes * (nzh / d) >= kMinCtas) best = p;
  }
  return best;
}

struct G12Args {
  const uint16_t* pre;  // (Nx*Nzh, sx*2*Ny)
  const uint16_t *myr, *myi, *mxr, *mxi;  // (C, sm, N, N)
  float *orh, *orl, *oih, *oil;           // (C, Nx, Ny, Nzh)
  int nx, ny, nzh, zb, sm, sx, w, fold_tail, nsl, nlev;
  int lg[2], tr[2];
};

// One stage as the block sees it: input rows (presliced from device memory,
// or the intermediate's float32 planes), the node's slices, and where row
// r, column l goes: (r / B) * sa + (r % B) * sb + l * sl.
struct Stage {
  int K, L, rows, lg, tr;
  const uint16_t* pre;  // stage 1: row r at ((r / zb) * nzh + r % zb) * pw
  int nzh;
  const float* x;       // stage 2: 4 planes of rows * K floats, plane stride xp
  int xp;
  const uint16_t *mre, *mim;  // (sm, K, L)
  float *orh, *orl, *oih, *oil;
  int B;
  long long sa, sb, sl;
};

// B operands of one k16 step of slice j for an 8-column strip, re and im
// together: ldmatrix.x4.trans, lanes 0-15 naming the re rows, 16-31 the im
// rows (b[0], b[1] = re; b[2], b[3] = im).
__device__ __forceinline__ void load_b_pair(const uint16_t* q, unsigned (&b)[4]) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(q));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(addr)
               : "memory");
}

// The slices j < nslt of columns [c0, c0 + lg), re and im, into shared
// memory (as oz_common.cuh load_slices, zero-padded rows and columns; the
// slices j >= nsl, which the matrices do not have, all zero): cp.async
// where the source allows it, else plain loads.  Issues the copies and
// returns; the caller waits (cp.async.wait_all) and synchronises.
__device__ __forceinline__ void issue_slices(const Stage& s, int c0, int lg, int nsl, int nslt,
                                             uint16_t* s_m) {
  const int K = s.K, Kp = padded_k(K), lp = padded_l(lg), ls = l_stride(lg);
  const int ms = Kp * ls, tid = threadIdx.x;
  const bool vec = lg % 8 == 0 && s.L % 8 == 0 && c0 % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(s.mre) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(s.mim) & 15) == 0;
  if (vec) {
    const int g = lg / 8, per = Kp * g;
    for (int idx = tid; idx < 2 * nslt * per; idx += kThreads) {
      const int sc = idx / per, rem = idx - sc * per, k = rem / g, c = rem - k * g;
      const uint16_t* src = ((sc & 1) ? s.mim : s.mre) + (size_t)(sc >> 1) * K * s.L;
      const bool in = k < K && (sc >> 1) < nsl;
      bfft_oz::cp_async16(s_m + (size_t)sc * ms + k * ls + 8 * c,
                          in ? src + (size_t)k * s.L + c0 + 8 * c : s.mre, in ? 16 : 0);
    }
  } else {
    const int per = Kp * lp;
    for (int idx = tid; idx < 2 * nslt * per; idx += kThreads) {
      const int sc = idx / per, rem = idx - sc * per, k = rem / lp, c = rem - k * lp;
      const uint16_t* src = ((sc & 1) ? s.mim : s.mre) + (size_t)(sc >> 1) * K * s.L;
      s_m[(size_t)sc * ms + k * ls + c] =
          (k < K && c < lg && (sc >> 1) < nsl) ? src[(size_t)k * s.L + c0 + c] : (uint16_t)0;
    }
  }
}

// Stage 1's chunks of rows [row0, row0 + nrows): copied from the presliced
// rows (chunk i: K re values, then K im values), zero-padded to tr rows, to
// padded_k(K) and to sxt chunks; cp.async where the source allows it.
__device__ __forceinline__ void issue_pre_chunks(const Stage& s, int row0, int nrows, int sx,
                                                 int sxt, uint16_t* s_cr, uint16_t* s_ci) {
  const int K = s.K, Kp = padded_k(K), KS = k_stride(K), TR = s.tr, cs = TR * KS;
  const long long pw = 2LL * sx * K;
  const int tid = threadIdx.x;
  const bool vec = K % 8 == 0 && (reinterpret_cast<uintptr_t>(s.pre) & 15) == 0;
  const int g = vec ? Kp / 8 : Kp, gk = vec ? K / 8 : K, width = vec ? 8 : 1;
  for (int idx = tid; idx < sxt * TR * g; idx += kThreads) {
    const int c = idx % g, r = (idx / g) % TR, i = idx / (g * TR);
    uint16_t* dr = s_cr + (size_t)i * cs + (size_t)r * KS + width * c;
    uint16_t* di = s_ci + (size_t)i * cs + (size_t)r * KS + width * c;
    const bool in = r < nrows && c < gk && i < sx;
    const int q = row0 + r;
    const uint16_t* pr =
        s.pre + (in ? ((long long)(q / s.B) * s.nzh + q % s.B) * pw + 2LL * i * K + width * c : 0);
    if (vec) {
      bfft_oz::cp_async16(dr, pr, in ? 16 : 0);
      bfft_oz::cp_async16(di, in ? pr + K : pr, in ? 16 : 0);
    } else {
      *dr = in ? pr[0] : (uint16_t)0;
      *di = in ? pr[K] : (uint16_t)0;
    }
  }
}

// Stage 2's chunks of rows [row0, row0 + nrows) of the intermediate: the
// merged row scale from the largest |hi| of the row's re and im values (one
// warp a row), then every value's sx chunks (oz_common.cuh extract_chunks),
// zero-padded (to sxt chunks too).  Synchronises between the two steps.
__device__ __forceinline__ void cut_chunks(const Stage& s, int row0, int nrows, int sx, int sxt,
                                           int w, uint16_t* s_cr, uint16_t* s_ci,
                                           unsigned* s_max) {
  const int K = s.K, Kp = padded_k(K), KS = k_stride(K), TR = s.tr, cs = TR * KS;
  const float *rh = s.x, *rl = s.x + s.xp, *ih = s.x + 2 * s.xp, *il = s.x + 3 * s.xp;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int r = warp; r < TR; r += kWarps) {
    unsigned m = 0u;
    if (r < nrows) {
      const float* a = rh + (size_t)(row0 + r) * K;
      const float* b = ih + (size_t)(row0 + r) * K;
      for (int k = lane; k < K; k += 32) {
        const unsigned u = __float_as_uint(fabsf(a[k])), v = __float_as_uint(fabsf(b[k]));
        m = u > m ? u : m;
        m = v > m ? v : m;
      }
    }
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0) s_max[r] = m;
  }
  __syncthreads();
  for (int idx = tid; idx < TR * Kp; idx += kThreads) {
    const int r = idx / Kp, k = idx - r * Kp;
    uint16_t* pr = s_cr + (size_t)r * KS + k;
    uint16_t* pi = s_ci + (size_t)r * KS + k;
    if (r < nrows && k < K) {
      const size_t off = (size_t)(row0 + r) * K + k;
      const float sr = bfft_oz::pow2_ceil_bits(s_max[r]);
      bfft_oz::extract_chunks(rh[off], rl[off], sr, w, sx, pr, cs);
      bfft_oz::extract_chunks(ih[off], il[off], sr, w, sx, pi, cs);
      for (int i = sx; i < sxt; ++i) pr[i * cs] = pi[i * cs] = 0;
    } else {
      for (int i = 0; i < sxt; ++i) pr[i * cs] = pi[i * cs] = 0;
    }
  }
}

// One warp's 16 x 8 output tile (rows m0.. of the row tile, columns n0.. of
// the column group; element e at row m0 + lane/4 + 8 (e/2), column n0 + 2
// (lane % 4) + e % 2) of the merged contraction, both lists (re = cr.mre -
// ci.mim, im = cr.mim + ci.mre).  For each k16 step and chunk i < SXT the A
// fragments (re, im) are loaded once; for each slice j with i + j < NLEV one
// tensor-core chain per list from a zeroed fragment (the second product
// against -im, a sign flip of the bf16 halves, exact), added in float32 to
// level i + j.  The pairs are fixed at compile time, so nvcc interleaves
// their loads and products; chunks past sx and slices past nsl are zero in
// shared memory and add exact zeros.  Then the levels d < n_fold are folded
// in order into (hi, lo): levels d < ft one by one, the rest summed in
// float32 and added once.
template <int NLEV>
__device__ __forceinline__ void warp_tile(const uint16_t* s_cr, const uint16_t* s_ci, int cs,
                                          int ks, const uint16_t* s_m, int ms, int ls, int kp,
                                          int n_fold, int ft, int m0, int n0, int lane,
                                          float (&hr)[4], float (&lr)[4], float (&hm)[4],
                                          float (&lm)[4]) {
  constexpr int SXT = NLEV < bfft_oz::SX_MAX ? NLEV : bfft_oz::SX_MAX;
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float acc[NLEV][2][4];
#pragma unroll
  for (int d = 0; d < NLEV; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][0][e] = acc[d][1][e] = 0.0f;
  const uint16_t* pa = s_cr + m0 * ks;
  const uint16_t* pb = s_ci + m0 * ks;
  const uint16_t* qb = s_m + (size_t)(lane >> 4) * ms + (lane & 15) * ls + n0;
#pragma unroll 1
  for (int kb = 0; kb < kp; kb += 16) {
#pragma unroll
    for (int i = 0; i < SXT; ++i) {
      unsigned a[4], a2[4];
      bfft_oz::load_a(pa + (size_t)i * cs + kb, ks, lane, a);
      bfft_oz::load_a(pb + (size_t)i * cs + kb, ks, lane, a2);
#pragma unroll
      for (int j = 0; i + j < NLEV; ++j) {
        unsigned b[4];
        load_b_pair(qb + (size_t)(2 * j) * ms + kb * ls, b);
        const unsigned br[2] = {b[0], b[1]}, bi[2] = {b[2], b[3]};
        const unsigned bn[2] = {b[2] ^ 0x80008000u, b[3] ^ 0x80008000u};
        float p[4], q[4];
        bfft_oz::mma_bf16(p, a, br, zero);
        bfft_oz::mma_bf16(p, a2, bn, p);
        bfft_oz::mma_bf16(q, a, bi, zero);
        bfft_oz::mma_bf16(q, a2, br, q);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i + j][0][e] += p[e];
          acc[i + j][1][e] += q[e];
        }
      }
    }
  }
  float t0[4], t1[4];
#pragma unroll
  for (int d = 0; d < NLEV; ++d) {
    if (d < n_fold) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (d < ft) {
          bfft_oz::add_float(hr[e], lr[e], acc[d][0][e]);
          bfft_oz::add_float(hm[e], lm[e], acc[d][1][e]);
        } else if (d == ft) {
          t0[e] = acc[d][0][e];
          t1[e] = acc[d][1][e];
        } else {
          t0[e] = t0[e] + acc[d][0][e];
          t1[e] = t1[e] + acc[d][1][e];
        }
      }
    }
  }
  if (ft < n_fold) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bfft_oz::add_float(hr[e], lr[e], t0[e]);
      bfft_oz::add_float(hm[e], lm[e], t1[e]);
    }
  }
}

// Both stages of one block.  Shared memory: the intermediate (4 planes of
// Ny * zb rows of Nx floats), then the stage's slices, chunks (re, im) and
// row maxima.
template <int NLEV>
__global__ void __launch_bounds__(kThreads, 1) gmain12_kernel(const G12Args a) {
  constexpr int SXT = NLEV < bfft_oz::SX_MAX ? NLEV : bfft_oz::SX_MAX;
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.y;
  const int z0 = blockIdx.x * a.zb;
  const int nx = a.nx, ny = a.ny, nzh = a.nzh, zb = a.zb, sx = a.sx;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int vb = nx * zb * ny;  // one plane of the intermediate
  float* s_t = smem;
  uint16_t* s_m = reinterpret_cast<uint16_t*>(smem + 4 * vb);
  const int n_fold = min(a.nlev, sx + a.sm - 1);
  const int ft = a.fold_tail < 0 ? n_fold : max(1, min(a.fold_tail, n_fold));
  for (int st = 0; st < 2; ++st) {
    Stage s;
    if (st == 0) {
      // rows r = jx*zb + dz read preslice row jx*Nzh + z0 + dz; column jy
      // -> s_t[(jy*zb + dz)*Nx + jx]
      s.K = ny;
      s.pre = a.pre + (size_t)z0 * (2 * sx * ny);
      s.nzh = nzh;
      s.x = nullptr;
      s.mre = a.myr + (size_t)c * a.sm * ny * ny;
      s.mim = a.myi + (size_t)c * a.sm * ny * ny;
      s.orh = s_t;
      s.orl = s_t + vb;
      s.oih = s_t + 2 * vb;
      s.oil = s_t + 3 * vb;
      s.rows = nx * zb;
      s.B = zb;
      s.sa = 1;
      s.sb = nx;
      s.sl = (long long)zb * nx;
    } else {
      // rows (jy, dz), K = Nx, from the intermediate; column jx ->
      // out[c, jx, jy, z0 + dz]
      const long long obase = (long long)c * nx * ny * nzh + z0;
      s.K = nx;
      s.pre = nullptr;
      s.x = s_t;
      s.xp = vb;
      s.mre = a.mxr + (size_t)c * a.sm * nx * nx;
      s.mim = a.mxi + (size_t)c * a.sm * nx * nx;
      s.rows = ny * zb;
      s.orh = a.orh + obase;
      s.orl = a.orl + obase;
      s.oih = a.oih + obase;
      s.oil = a.oil + obase;
      s.B = zb;
      s.sa = nzh;
      s.sb = 1;
      s.sl = (long long)ny * nzh;
    }
    s.L = s.K;
    s.lg = a.lg[st];
    s.tr = a.tr[st];
    const int K = s.K, Kp = padded_k(K), KS = k_stride(K), TR = s.tr, cs = TR * KS;
    for (int c0 = 0; c0 < s.L; c0 += s.lg) {
      const int lg = min(s.lg, s.L - c0), LS = l_stride(lg), ms = Kp * LS;
      uint16_t* s_cr = s_m + 2 * (size_t)NLEV * ms;
      uint16_t* s_ci = s_cr + (size_t)SXT * cs;
      unsigned* s_max = reinterpret_cast<unsigned*>(s_ci + (size_t)SXT * cs);
      __syncthreads();  // the previous stage or group is done with the slices and chunks
      issue_slices(s, c0, lg, a.nsl, NLEV, s_m);
      const int nst = (lg + 7) / 8;
      for (int row0 = 0; row0 < s.rows; row0 += TR) {
        const int nrows = min(TR, s.rows - row0);
        if (row0 > 0) __syncthreads();  // the previous row tile is done with the chunks
        if (st == 0)
          issue_pre_chunks(s, row0, nrows, sx, SXT, s_cr, s_ci);
        else
          cut_chunks(s, row0, nrows, sx, SXT, a.w, s_cr, s_ci, s_max);
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncthreads();
        const int n_mt = (nrows + 15) / 16;
        for (int wt = warp; wt < n_mt * nst; wt += kWarps) {
          const int m0 = (wt / nst) * 16, n0 = (wt % nst) * 8;
          float hr[4] = {}, lr[4] = {}, hm[4] = {}, lm[4] = {};
          warp_tile<NLEV>(s_cr, s_ci, cs, KS, s_m, ms, LS, Kp, n_fold, ft, m0, n0, lane, hr, lr,
                          hm, lm);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rr = m0 + (lane >> 2) + 8 * (e >> 1);
            const int l = n0 + 2 * (lane & 3) + (e & 1);
            if (rr < nrows && l < lg) {
              const long long r = row0 + rr;
              const long long o = (r / s.B) * s.sa + (r % s.B) * s.sb + (long long)(c0 + l) * s.sl;
              s.orh[o] = hr[e];
              s.orl[o] = lr[e];
              s.oih[o] = hm[e];
              s.oil[o] = lm[e];
            }
          }
        }
      }
    }
  }
}

template <int NLEV>
int launch(const G12Args& a, int n_nodes, size_t smem, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      gmain12_kernel<NLEV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  gmain12_kernel<NLEV><<<dim3(a.nzh / a.zb, n_nodes), kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// K10's plan for (nx, ny, nzh, n_nodes), sx chunk planes and nsl slices
// in shared memory (the kernel keeps 7 and 7 for nlev <= 7, 7 and 8 for
// nlev = 8), and the z block zb (0: the rule's): out = {zb, lg stage 1, tr stage 1, lg stage 2, tr stage 2,
// shared-memory bytes, fits}.  Returns 0, or cudaErrorInvalidValue for bad
// arguments.
extern "C" int bfft_oz_gmain12_plan(int nx, int ny, int nzh, int n_nodes, int sx, int nsl,
                                    int zb, void* out) {
  if (nx < 1 || ny < 1 || nzh < 1 || n_nodes < 1 || sx < 1 || nsl < 1 || zb < 0 ||
      (zb > 0 && nzh % zb))
    return cudaErrorInvalidValue;
  const G12Plan p = make_plan(nx, ny, nzh, n_nodes, sx, nsl, zb);
  int* o = static_cast<int*>(out);
  o[0] = p.zb;
  o[1] = p.lg[0];
  o[2] = p.tr[0];
  o[3] = p.lg[1];
  o[4] = p.tr[1];
  o[5] = (int)p.smem;
  o[6] = p.zb > 0 && fits(p) ? 1 : 0;
  return 0;
}

extern "C" int bfft_oz_gmain12(const void* pre, const void* myr, const void* myi,
                               const void* mxr, const void* mxi, void* orh, void* orl,
                               void* oih, void* oil, int n_nodes, int nx, int ny, int nzh,
                               int zb, int sm, int nlev, int sx, int w, int fold_tail,
                               void* stream) {
  if (n_nodes < 1 || n_nodes > 65535 || nx < 1 || ny < 1 || nzh < 1 || zb < 0 ||
      (zb > 0 && nzh % zb) || sm < 1 || sm > bfft_oz::SM_MAX || sx < 1 ||
      sx > bfft_oz::SX_MAX || nlev < 1 || nlev > kMaxLev)
    return cudaErrorInvalidValue;
  // the kernel's instance: NLEV levels, 7 chunk planes and NLEV slices in
  // shared memory (zero past sx and sm)
  const int nl = nlev <= 7 ? 7 : 8;
  const G12Plan p = make_plan(nx, ny, nzh, n_nodes, bfft_oz::SX_MAX, nl, zb);
  if (p.zb == 0 || !fits(p)) return cudaErrorInvalidValue;
  G12Args a;
  a.nsl = sm < nlev ? sm : nlev;
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
  a.zb = p.zb;
  a.sm = sm;
  a.sx = sx;
  a.w = w;
  a.fold_tail = fold_tail;
  for (int s = 0; s < 2; ++s) {
    a.lg[s] = p.lg[s];
    a.tr[s] = p.tr[s];
  }
  const cudaStream_t st = (cudaStream_t)stream;
  return nl == 7 ? launch<7>(a, n_nodes, p.smem, st) : launch<8>(a, n_nodes, p.smem, st);
}
