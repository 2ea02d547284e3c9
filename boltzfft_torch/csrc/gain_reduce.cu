// K5 for Hopper: the weighted node reduction of the rfft + use_pallas route,
// for float and double.
//
// Replaces boltzfft/pallas_kernels.py::_gain_reduce_kernel, reached through
// gain_reduce from operator._gain_chunk_pallas (and timed alone by
// cli/loop_benchmark.py).  For a chunk of B nodes and M flattened modes:
//
//   out[l] = sum_b  w_b(l) h[b, l],
//   w_b(l) = (amp gw_b) sin(a) / a,   a = (coef rho_b) |l| + eps,
//   amp = 4 pi b_gamma, coef = pi / (2 L),
//
// with beta1 computed in registers, never stored.  The sum's order is the
// TPU kernel's: the nodes fall in B / nb blocks of nb = gcd(node_block, B),
// each block summed from zero in node order (S_j), and the block sums added
// into the output from zero in block order, ((0 + S_0) + S_1) + ...  So
// node_block enters the result, as it does in JAX.  Every product and sum
// is rounded on its own (no contraction into an FMA), as in the plain
// version; the two differ only by their sin.
//
// What bounds it on this card: bytes.  It reads h once, 2 B M reals (0.83 GB
// at 64^3 / Ns = 12 in double, M = 64 * 64 * 33: 0.25 ms at 3.35 TB/s; 53 MB
// at 32^3), and writes 2 M.  Per (b, l) it does one sin, one divide and a
// few multiplies and adds.
//
// What the design does about it:
//  - a thread owns kModes = 2 neighbouring modes (one 16-byte load a node in
//    float, where M is even and h aligned; two in double), a block of
//    kThreads = 128 threads a tile of 256 modes;
//  - a thread issues the loads of AHEAD nodes before their arithmetic,
//    across node-block boundaries (the arithmetic keeps the block order):
//    8 on the one-launch route, 4 on the split route, whose blocks then
//    hold fewer registers and more of them fit an SM (measured: 4 faster at
//    32^3, 8 at 64^3);
//  - a block stages its nodes' (coef rho, amp gw) in shared memory once, or
//    kStage (1024) at a time where they are more, so any B fits; the stage
//    loop is a variant of its own (STAGED), since in the one kernel it
//    took 12 more registers, a block fewer per SM and 57% more time at 64^3
//    in double (NVIDIA H100 80GB HBM3, 700 W; tools/ds_kernels_ab.py);
//  - two routes, chosen by the caller (kernels.gain_reduce.plan, from the
//    card's SM count): where the mode tiles alone give every SM a block
//    (64^3: 528 tiles on the H100's 132), one block walks every node block
//    of its tile in order; where they do not (32^3: 68 tiles), the split
//    route runs a 2-D grid of tiles x node blocks that writes each S_j to a
//    (B / nb, M) scratch, and a second launch adds them into the output in
//    block order.  Both routes do the same operations in the same order:
//    bitwise equal, and run to run.  The split route takes at most 65535
//    node blocks (the grid's y limit); the plan never picks it above that.
// M need not be a multiple of anything: the ragged last tile is masked.
//
// The entry points return cudaGetLastError() of their launches; they launch
// on the given stream, do not synchronise and allocate nothing (the wrapper
// allocates the scratch).

#include "spectral_common.cuh"

namespace {

using bfft::Cplx;

constexpr int kThreads = 128;
constexpr int kModes = 2;
constexpr int kTile = kThreads * kModes;
constexpr int kSumThreads = 64;  // the split route's second launch: one mode a thread
constexpr int kStage = 1024;     // nodes whose (coef rho, amp gw) a block stages at a time

// nb, the number of node blocks and the mode tiles
void gr_plan(int b, int m, int node_block, int* out) {
  int x = node_block, y = b;
  while (y) {
    const int r = x % y;
    x = y;
    y = r;
  }
  out[0] = x;
  out[1] = b / x;
  out[2] = (m + kTile - 1) / kTile;
}

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// the two modes l0, l0 + 1 of row p (VEC in float: one 16-byte load of two
// float2; in double each mode is a 16-byte load of its own)
template <typename T, bool VEC>
__device__ __forceinline__ void load2(const typename Cplx<T>::type* __restrict__ p, bool second,
                                      typename Cplx<T>::type (&v)[kModes]) {
  if constexpr (VEC && sizeof(T) == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0].x = q.x;
    v[0].y = q.y;
    v[1].x = q.z;
    v[1].y = q.w;
  } else {
    v[0] = __ldg(p);
    if (second) {
      v[1] = __ldg(p + 1);
    } else {
      v[1].x = 0;
      v[1].y = 0;
    }
  }
}

// (coef rho_b, amp gw_b) of nodes [st0, st1) into s_cr, s_ag, by the block
template <typename T>
__device__ __forceinline__ void stage_weights(const T* __restrict__ rho, const T* __restrict__ gw,
                                              T coef, T amp, int st0, int st1, T* s_cr, T* s_ag) {
  for (int k = threadIdx.x; k < st1 - st0; k += kThreads) {
    s_cr[k] = mul_rn(coef, rho[st0 + k]);
    s_ag[k] = mul_rn(amp, gw[st0 + k]);
  }
}

// A thread's sums: s the current node block's, acc the output's (one launch)
template <typename T>
struct Sums {
  typename Cplx<T>::type s[kModes], acc[kModes];
  int left;  // nodes left in the current block
};

// Nodes [c_begin, c_end) of modes l0, l0 + 1, their weights staged from node
// st0 on: loads of AHEAD nodes, then their arithmetic, in node order
template <typename T, bool VEC, int AHEAD>
__device__ __forceinline__ void walk(const typename Cplx<T>::type* __restrict__ h, const T* s_cr,
                                     const T* s_ag, int st0, int c_begin, int c_end, int m,
                                     int l0, bool second, const T (&nl)[kModes], int nb,
                                     bool split, T eps, Sums<T>& t) {
  using C2 = typename Cplx<T>::type;
#pragma unroll 1
  for (int c0 = c_begin; c0 < c_end; c0 += AHEAD) {
    const int cnt = min(AHEAD, c_end - c0);
    C2 v[AHEAD][kModes];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k)
      if (k < cnt) load2<T, VEC>(h + (size_t)(c0 + k) * m + l0, second, v[k]);
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      if (k < cnt) {
        if (t.left == 0) {
#pragma unroll
          for (int i = 0; i < kModes; ++i) {
            t.s[i].x = 0;
            t.s[i].y = 0;
          }
          t.left = nb;
        }
        const T cr = s_cr[c0 + k - st0], ag = s_ag[c0 + k - st0];
#pragma unroll
        for (int i = 0; i < kModes; ++i) {
          const T arg = add_rn(mul_rn(cr, nl[i]), eps);
          const T w = mul_rn(ag, bfft::dev_sin(arg)) / arg;
          t.s[i].x = add_rn(t.s[i].x, mul_rn(w, v[k][i].x));
          t.s[i].y = add_rn(t.s[i].y, mul_rn(w, v[k][i].y));
        }
        if (--t.left == 0 && !split) {
#pragma unroll
          for (int i = 0; i < kModes; ++i) {
            t.acc[i].x = add_rn(t.acc[i].x, t.s[i].x);
            t.acc[i].y = add_rn(t.acc[i].y, t.s[i].y);
          }
        }
      }
    }
  }
}

// split 0, grid (tiles, 1): every node block of the tile, into out.  split
// 1, grid (tiles, B / nb): node block blockIdx.y of the tile, S_j into row j
// of out (the scratch).  STAGED where the block's nodes outnumber kStage:
// their weights staged kStage at a time (kStage is a multiple of AHEAD, so
// the chunks are those of one walk); otherwise all at once, and the ragged
// last tile's idle threads leave after staging.
template <typename T, bool VEC, int AHEAD, bool STAGED>
__global__ void __launch_bounds__(kThreads)
    gain_reduce_kernel(const typename Cplx<T>::type* __restrict__ h, const T* __restrict__ rho,
                       const T* __restrict__ gw, const T* __restrict__ norm_l,
                       typename Cplx<T>::type* __restrict__ out, int n_nodes, int m, int nb,
                       bool split, T coef, T amp, T eps) {
  using C2 = typename Cplx<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b0 = split ? blockIdx.y * nb : 0;
  const int b1 = split ? b0 + nb : n_nodes;
  T* s_cr = reinterpret_cast<T*>(smem_raw);         // coef rho_b
  T* s_ag = s_cr + (STAGED ? kStage : b1 - b0);     // amp gw_b
  const int l0 = (blockIdx.x * kThreads + threadIdx.x) * kModes;
  if constexpr (!STAGED) {
    stage_weights(rho, gw, coef, amp, b0, b1, s_cr, s_ag);
    __syncthreads();
    if (l0 >= m) return;
  }
  const bool active = l0 < m;
  const bool second = l0 + 1 < m;
  T nl[kModes];
  nl[0] = active ? norm_l[l0] : T(0);
  nl[1] = second ? norm_l[l0 + 1] : T(0);
  Sums<T> t;
#pragma unroll
  for (int i = 0; i < kModes; ++i) {
    t.acc[i].x = 0;
    t.acc[i].y = 0;
  }
  t.left = 0;
  if constexpr (STAGED) {
#pragma unroll 1
    for (int st0 = b0; st0 < b1; st0 += kStage) {
      const int st1 = min(st0 + kStage, b1);
      if (st0 != b0) __syncthreads();  // the last stage read by every thread
      stage_weights(rho, gw, coef, amp, st0, st1, s_cr, s_ag);
      __syncthreads();
      if (active)
        walk<T, VEC, AHEAD>(h, s_cr, s_ag, st0, st0, st1, m, l0, second, nl, nb, split, eps, t);
    }
    if (!active) return;
  } else {
    walk<T, VEC, AHEAD>(h, s_cr, s_ag, b0, b0, b1, m, l0, second, nl, nb, split, eps, t);
  }
  if (split) {
    C2* o = out + (size_t)blockIdx.y * m;
    o[l0] = t.s[0];
    if (second) o[l0 + 1] = t.s[1];
  } else {
    out[l0] = t.acc[0];
    if (second) out[l0 + 1] = t.acc[1];
  }
}

// The split route's second launch: out[l] = ((0 + S_0) + S_1) + ...
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
    block_sum_kernel(const typename Cplx<T>::type* __restrict__ scratch,
                     typename Cplx<T>::type* __restrict__ out, int n_blocks, int m) {
  using C2 = typename Cplx<T>::type;
  const int l = blockIdx.x * kSumThreads + threadIdx.x;
  if (l >= m) return;
  C2 acc;
  acc.x = 0;
  acc.y = 0;
#pragma unroll 8
  for (int j = 0; j < n_blocks; ++j) {
    const C2 v = __ldg(scratch + (size_t)j * m + l);
    acc.x = add_rn(acc.x, v.x);
    acc.y = add_rn(acc.y, v.y);
  }
  out[l] = acc;
}

template <typename T, bool VEC, int AHEAD, bool STAGED>
cudaError_t launch_staged(const typename Cplx<T>::type* h, const T* rho, const T* gw,
                          const T* norm_l, typename Cplx<T>::type* dst, const int* p, int n_nodes,
                          int m, bool split, T coef, T amp, T eps, cudaStream_t st) {
  static_assert(kStage % AHEAD == 0, "a stage holds whole chunks");
  const size_t smem = 2 * (size_t)(STAGED ? kStage : split ? p[0] : n_nodes) * sizeof(T);
  const dim3 grid((unsigned)p[2], split ? (unsigned)p[1] : 1u);
  gain_reduce_kernel<T, VEC, AHEAD, STAGED><<<grid, kThreads, smem, st>>>(
      h, rho, gw, norm_l, dst, n_nodes, m, p[0], split, coef, amp, eps);
  return cudaGetLastError();
}

template <typename T, bool VEC, int AHEAD>
cudaError_t launch_ahead(const typename Cplx<T>::type* h, const T* rho, const T* gw,
                         const T* norm_l, typename Cplx<T>::type* dst, const int* p, int n_nodes,
                         int m, bool split, T coef, T amp, T eps, cudaStream_t st) {
  return (split ? p[0] : n_nodes) > kStage  // shared memory: at most 16 KB either way
             ? launch_staged<T, VEC, AHEAD, true>(h, rho, gw, norm_l, dst, p, n_nodes, m, split,
                                                  coef, amp, eps, st)
             : launch_staged<T, VEC, AHEAD, false>(h, rho, gw, norm_l, dst, p, n_nodes, m,
                                                   split, coef, amp, eps, st);
}

template <typename T, bool VEC>
cudaError_t launch(const typename Cplx<T>::type* h, const T* rho, const T* gw, const T* norm_l,
                   typename Cplx<T>::type* dst, const int* p, int n_nodes, int m, bool split,
                   T coef, T amp, T eps, cudaStream_t st) {
  return split ? launch_ahead<T, VEC, 4>(h, rho, gw, norm_l, dst, p, n_nodes, m, split, coef,
                                         amp, eps, st)
               : launch_ahead<T, VEC, 8>(h, rho, gw, norm_l, dst, p, n_nodes, m, split, coef,
                                         amp, eps, st);
}

template <typename T>
int gain_reduce(const typename Cplx<T>::type* h, const T* rho, const T* gw, const T* norm_l,
                typename Cplx<T>::type* out, typename Cplx<T>::type* scratch, int n_nodes, int m,
                int node_block, int split, double coef, double amp, double eps,
                cudaStream_t st) {
  if (n_nodes < 1 || m < 1 || node_block < 1 || split < 0 || split > 1 ||
      (split && scratch == nullptr))
    return cudaErrorInvalidValue;
  int p[3];
  gr_plan(n_nodes, m, node_block, p);
  if (split && p[1] > 65535) return cudaErrorInvalidValue;  // the grid's y limit
  const bool vec = m % 2 == 0 && ((uintptr_t)h) % 16 == 0;
  auto* dst = split ? scratch : out;
  cudaError_t err =
      vec ? launch<T, true>(h, rho, gw, norm_l, dst, p, n_nodes, m, split, (T)coef, (T)amp,
                            (T)eps, st)
          : launch<T, false>(h, rho, gw, norm_l, dst, p, n_nodes, m, split, (T)coef, (T)amp,
                             (T)eps, st);
  if (err != cudaSuccess || !split) return err;
  block_sum_kernel<T><<<(m + kSumThreads - 1) / kSumThreads, kSumThreads, 0, st>>>(scratch, out,
                                                                                  p[1], m);
  return cudaGetLastError();
}

}  // namespace

// nb, the number of node blocks and the mode tiles (kTile modes each) for B
// nodes, M modes and node_block
extern "C" int bfft_gain_reduce_plan(int n_nodes, int m, int node_block, void* out) {
  if (n_nodes < 1 || m < 1 || node_block < 1 || out == nullptr) return cudaErrorInvalidValue;
  gr_plan(n_nodes, m, node_block, (int*)out);
  return cudaSuccess;
}

// split: 0 one launch, 1 the split route through scratch ((B / nb, M) complex,
// at most 65535 node blocks); the caller's plan picks it
#define BFFT_REDUCE_ENTRY(NAME, T, C2)                                                     \
  extern "C" int NAME(const void* h, const void* rho, const void* gw, const void* norm_l,  \
                      void* out, void* scratch, int n_nodes, int m, int node_block,        \
                      int split, double coef, double amp, double eps, void* stream) {      \
    return gain_reduce<T>((const C2*)h, (const T*)rho, (const T*)gw, (const T*)norm_l,     \
                          (C2*)out, (C2*)scratch, n_nodes, m, node_block, split, coef, amp, \
                          eps, (cudaStream_t)stream);                                      \
  }

BFFT_REDUCE_ENTRY(bfft_gain_reduce_f32, float, float2)
BFFT_REDUCE_ENTRY(bfft_gain_reduce_f64, double, double2)
