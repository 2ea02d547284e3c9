// K11 for Hopper: the full-stream Hadamard product and weighted node sum of
// the ds engine, sum_j w_j (g1_j . g2_j), complex ds in and out.
//
// Replaces boltzfft/oz.py::_hadamard_wsum_kernel (hadamard_wsum), the oz
// engine's Hadamard on its full g-streams (g_stream="full", and tables built
// without the per-node matrices).  Per output element, for the nodes j in
// order:
//   h = g1_j * g2_j          (ds.cmul: rr - ii, ri + ir, products g1-first)
//   t = h * w_j              (ds.cmul_ds, when a weight is given)
//   s = t at j = 0, else s + t   (ds.cadd)
// the EFTs of oz_common.cuh, compiled with --fmad=false.
//
// What bounds it on this card: bytes.  Per node it reads both streams' four
// float32 planes (32 B per element) and does ~160 float operations per
// element (four ds products, two ds adds, two weight products, two sum
// adds): about 5 operations per byte, far below the card's ~20 float32
// operations per byte of device memory.
//
// What the design does about it: each thread walks the C nodes in order
// with its elements' sums in registers (no atomics, no second pass, bitwise
// reproducible), and the output is written once.  The streams are read in
// place through their strides (node, then three per-node axes in the first
// stream's memory order, d3 its innermost): the full routes hand over the x
// stage's rolled views, and a copy of the eight planes into order would
// cost more than the kernel.  Two walks, both with 32-bit index math:
// - direct, where the output's unit axis is the stream's innermost (or the
//   stream has no unit axis): V consecutive elements a thread, loaded and
//   stored as float4 (V = 4) or float2 where every stride and pointer
//   allows it;
// - transposing, where the output's unit axis is another (the rolled
//   views): a block takes 32 elements along d3 by TY = 4 EPT along the
//   output's unit axis, reads them along d3, stages the four result planes
//   in shared memory and writes them along the output's unit axis, so both
//   the reads and the writes coalesce.
// V and EPT are the largest that leave the grid at least kMinBlocks blocks
// of 128 threads (two for each of the 132 SMs).  The TPU kernel's node grid
// axis with output-block revisiting, and its 128-lane tiling rule, have no
// counterpart: every shape runs the kernel.
//
// The entry point returns cudaGetLastError() of its launch; it launches on
// the given stream, does not synchronise and allocates nothing.

#include "oz_common.cuh"

namespace {

using bfft_oz::ds_add;
using bfft_oz::ds_mul;

constexpr int kThreads = 128;
constexpr int kMinBlocks = 264;

struct HArgs {
  const float *g1rh, *g1rl, *g1ih, *g1il;  // (C, d1, d2, d3), strides s1
  const float *g2rh, *g2rl, *g2ih, *g2il;  // (C, d1, d2, d3), strides s2
  const float *wh, *wl;                    // (C,) at stride sw, or null
  float *orh, *orl, *oih, *oil;            // (d1, d2, d3), strides so
  int c, sw;
  int d[3];
  int s1[4], s2[4], so[3];  // element strides: node, axes 1, 2, 3
};

template <int V>
__device__ __forceinline__ void load_v(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// The node sum of V consecutive elements of unit stride (V = 1: one element
// at any stride) at offsets o1 (stream 1) and o2 (stream 2) of node 0.
template <int V>
__device__ __forceinline__ void node_sum(const HArgs& a, int o1, int o2, float (&srh)[V],
                                         float (&srl)[V], float (&sih)[V], float (&sil)[V]) {
  for (int j = 0; j < a.c; ++j, o1 += a.s1[0], o2 += a.s2[0]) {
    float arh[V], arl[V], aih[V], ail[V], brh[V], brl[V], bih[V], bil[V];
    load_v<V>(a.g1rh + o1, arh);
    load_v<V>(a.g1rl + o1, arl);
    load_v<V>(a.g1ih + o1, aih);
    load_v<V>(a.g1il + o1, ail);
    load_v<V>(a.g2rh + o2, brh);
    load_v<V>(a.g2rl + o2, brl);
    load_v<V>(a.g2ih + o2, bih);
    load_v<V>(a.g2il + o2, bil);
    float wh = 0.0f, wl = 0.0f;
    if (a.wh != nullptr) {
      wh = a.wh[j * a.sw];
      wl = a.wl[j * a.sw];
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float rrh, rrl, iih, iil, rih, ril, irh, irl, trh, trl, tih, til;
      ds_mul(arh[v], arl[v], brh[v], brl[v], rrh, rrl);
      ds_mul(aih[v], ail[v], bih[v], bil[v], iih, iil);
      ds_mul(arh[v], arl[v], bih[v], bil[v], rih, ril);
      ds_mul(aih[v], ail[v], brh[v], brl[v], irh, irl);
      ds_add(rrh, rrl, -iih, -iil, trh, trl);
      ds_add(rih, ril, irh, irl, tih, til);
      if (a.wh != nullptr) {
        ds_mul(trh, trl, wh, wl, trh, trl);
        ds_mul(tih, til, wh, wl, tih, til);
      }
      if (j == 0) {
        srh[v] = trh;
        srl[v] = trl;
        sih[v] = tih;
        sil[v] = til;
      } else {
        ds_add(srh[v], srl[v], trh, trl, srh[v], srl[v]);
        ds_add(sih[v], sil[v], tih, til, sih[v], sil[v]);
      }
    }
  }
}

// The direct walk: thread t takes elements V t .. V t + V - 1 of the
// (d1, d2, d3) order (d3 % V == 0 where V > 1).
template <int V>
__global__ void __launch_bounds__(kThreads) hadamard_direct_kernel(const HArgs a) {
  const int n = a.d[0] * a.d[1] * a.d[2];
  const int e = (int)(blockIdx.x * kThreads + threadIdx.x) * V;
  if (e >= n) return;
  const int i3 = e % a.d[2], q = e / a.d[2], i2 = q % a.d[1], i1 = q / a.d[1];
  const int o1 = i1 * a.s1[1] + i2 * a.s1[2] + i3 * a.s1[3];
  const int o2 = i1 * a.s2[1] + i2 * a.s2[2] + i3 * a.s2[3];
  const int oe = i1 * a.so[0] + i2 * a.so[1] + i3 * a.so[2];
  float srh[V], srl[V], sih[V], sil[V];
  node_sum<V>(a, o1, o2, srh, srl, sih, sil);
  store_v<V>(a.orh + oe, srh);
  store_v<V>(a.orl + oe, srl);
  store_v<V>(a.oih + oe, sih);
  store_v<V>(a.oil + oe, sil);
}

// The transposing walk: block (bx, by, bz) takes d3 indices 32 bx .. + 31
// and indices TY by .. + TY - 1 of the output's unit axis ax (0 or 1), at
// index bz of the third axis.  Thread (tx, ty) = (t % 32, t / 32) sums the
// elements (32 bx + tx, TY by + ty + 4k), k < EPT; the results go through
// shared memory and out along ax, consecutive threads on consecutive
// indices of ax.
template <int EPT>
__global__ void __launch_bounds__(kThreads) hadamard_transpose_kernel(const HArgs a, int ax) {
  constexpr int TY = 4 * EPT;
  __shared__ float tile[4][TY][33];
  const int b = 1 - ax;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int x0 = blockIdx.x * 32, y0 = blockIdx.y * TY, ib = blockIdx.z;
  const int dx = a.d[2], dy = a.d[ax];
  const int ix = x0 + tx;
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    const int iy = y0 + ty + 4 * k;
    if (ix < dx && iy < dy) {
      const int o1 = ib * a.s1[1 + b] + iy * a.s1[1 + ax] + ix * a.s1[3];
      const int o2 = ib * a.s2[1 + b] + iy * a.s2[1 + ax] + ix * a.s2[3];
      float srh[1], srl[1], sih[1], sil[1];
      node_sum<1>(a, o1, o2, srh, srl, sih, sil);
      tile[0][ty + 4 * k][tx] = srh[0];
      tile[1][ty + 4 * k][tx] = srl[0];
      tile[2][ty + 4 * k][tx] = sih[0];
      tile[3][ty + 4 * k][tx] = sil[0];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < 32 * TY; idx += kThreads) {
    const int yl = idx % TY, xl = idx / TY, iy = y0 + yl, jx = x0 + xl;
    if (jx < dx && iy < dy) {
      const int oe = ib * a.so[b] + iy * a.so[ax] + jx * a.so[2];
      a.orh[oe] = tile[0][yl][xl];
      a.orl[oe] = tile[1][yl][xl];
      a.oih[oe] = tile[2][yl][xl];
      a.oil[oe] = tile[3][yl][xl];
    }
  }
}

bool aligned(const void* p, int bytes) { return (reinterpret_cast<uintptr_t>(p) % bytes) == 0; }

// Whether the direct walk can move V elements at once: unit strides along
// d3 in both streams and the output, every other stride and d3 a multiple
// of V, every pointer aligned to V floats.
bool vector_ok(const HArgs& a, int V) {
  if (a.s1[3] != 1 || a.s2[3] != 1 || a.so[2] != 1 || a.d[2] % V) return false;
  for (int i = 0; i < 3; ++i)
    if (a.s1[i] % V || a.s2[i] % V || (i < 2 && a.so[i] % V)) return false;
  const void* ptrs[12] = {a.g1rh, a.g1rl, a.g1ih, a.g1il, a.g2rh, a.g2rl,
                          a.g2ih, a.g2il, a.orh,  a.orl,  a.oih,  a.oil};
  for (const void* p : ptrs)
    if (!aligned(p, 4 * V)) return false;
  return true;
}

int launch(const HArgs& a, cudaStream_t st) {
  const int n = a.d[0] * a.d[1] * a.d[2];
  // the output's unit axis, among the axes longer than 1
  int ax = 2;
  for (int i = 0; i < 3; ++i)
    if (a.so[i] == 1 && a.d[i] > 1) ax = i;
  if (ax != 2 && a.s1[3] == 1 && a.d[2] > 1 && a.d[1 - ax] <= 65535) {
    const int bx = (a.d[2] + 31) / 32, bz = a.d[1 - ax];
    int ept = 8;
    while (ept > 1 && (long long)bx * ((a.d[ax] + 4 * ept - 1) / (4 * ept)) * bz < kMinBlocks)
      ept /= 2;
    const dim3 grid(bx, (a.d[ax] + 4 * ept - 1) / (4 * ept), bz);
    switch (ept) {
      case 8: hadamard_transpose_kernel<8><<<grid, kThreads, 0, st>>>(a, ax); break;
      case 4: hadamard_transpose_kernel<4><<<grid, kThreads, 0, st>>>(a, ax); break;
      case 2: hadamard_transpose_kernel<2><<<grid, kThreads, 0, st>>>(a, ax); break;
      default: hadamard_transpose_kernel<1><<<grid, kThreads, 0, st>>>(a, ax); break;
    }
    return cudaGetLastError();
  }
  int v = 4;
  while (v > 1 && (!vector_ok(a, v) || (n / v + kThreads - 1) / kThreads < kMinBlocks)) v /= 2;
  const unsigned blocks = (unsigned)((n / v + kThreads - 1) / kThreads);
  switch (v) {
    case 4: hadamard_direct_kernel<4><<<blocks, kThreads, 0, st>>>(a); break;
    case 2: hadamard_direct_kernel<2><<<blocks, kThreads, 0, st>>>(a); break;
    default: hadamard_direct_kernel<1><<<blocks, kThreads, 0, st>>>(a); break;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int bfft_oz_hadamard(const void* g1rh, const void* g1rl, const void* g1ih,
                                const void* g1il, const void* g2rh, const void* g2rl,
                                const void* g2ih, const void* g2il, const void* wh,
                                const void* wl, void* orh, void* orl, void* oih, void* oil,
                                int c, int d1, int d2, int d3, int s10, int s11, int s12,
                                int s13, int s20, int s21, int s22, int s23, int so1,
                                int so2, int so3, int sw, void* stream) {
  if (c < 1 || d1 < 1 || d2 < 1 || d3 < 1 || sw < 0 || (wh == nullptr) != (wl == nullptr))
    return cudaErrorInvalidValue;
  HArgs a;
  a.g1rh = (const float*)g1rh;
  a.g1rl = (const float*)g1rl;
  a.g1ih = (const float*)g1ih;
  a.g1il = (const float*)g1il;
  a.g2rh = (const float*)g2rh;
  a.g2rl = (const float*)g2rl;
  a.g2ih = (const float*)g2ih;
  a.g2il = (const float*)g2il;
  a.wh = (const float*)wh;
  a.wl = (const float*)wl;
  a.orh = (float*)orh;
  a.orl = (float*)orl;
  a.oih = (float*)oih;
  a.oil = (float*)oil;
  a.c = c;
  a.sw = sw;
  const int d[3] = {d1, d2, d3};
  const int s1[4] = {s10, s11, s12, s13}, s2[4] = {s20, s21, s22, s23};
  const int so[3] = {so1, so2, so3};
  // every offset the walks form must stay below 2^31
  long long m1 = (long long)(c - 1) * s10, m2 = (long long)(c - 1) * s20, mo = 0;
  for (int i = 0; i < 3; ++i) {
    if (s1[i + 1] < 0 || s2[i + 1] < 0 || so[i] < 0) return cudaErrorInvalidValue;
    m1 += (long long)(d[i] - 1) * s1[i + 1];
    m2 += (long long)(d[i] - 1) * s2[i + 1];
    mo += (long long)(d[i] - 1) * so[i];
    a.d[i] = d[i];
    a.so[i] = so[i];
  }
  if (s10 < 0 || s20 < 0 || (long long)d1 * d2 * d3 >= (1LL << 31) || m1 >= (1LL << 31) ||
      m2 >= (1LL << 31) || mo >= (1LL << 31) || (long long)(c - 1) * sw >= (1LL << 31))
    return cudaErrorInvalidValue;
  for (int i = 0; i < 4; ++i) {
    a.s1[i] = s1[i];
    a.s2[i] = s2[i];
  }
  return launch(a, (cudaStream_t)stream);
}
