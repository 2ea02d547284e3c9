// K12 for Hopper: the half-spectrum Hadamard product and radial-group sum of
// the ds engine, Re sum_j w_j g1_j g2_j per group, float32 pairs, with an
// optional running sum added at the end.
//
// Replaces boltzfft/oz.py::_hwh_kernel (hadamard_wsum_half).  Each g stream
// arrives factored as a real main block r (C, Nx, Ny, Nz) and three plane
// corrections px (C, Ny, Nz), py (C, Nx, Nz), pz (C, Nx, Ny), complex ds.
// Per output element and node j of a group, in order:
//   g = r + sx(jx) px + sy(jy) py + sz(jz) pz    (re; im from the planes alone;
//       the +-1 parity multiplies are exact; ds adds in _assemble_g_half's order)
//   t = R1 R2 - E1 E2                             (ds.cmul's real part)
//   t = t * w_j                                   (when a weight is given)
//   s = t at the group's first node, else s + t   (compensated, node order)
// and, where a running sum acc is given, out = acc + s (ds.add(acc, s), the
// add collide_ds made after each call before; the JAX function has no acc).
// Only Re is formed: the pipeline's Re(IFFT(beta1 FFT(.))) annihilates Im.
//
// What bounds it on this card: bytes.  Per node it reads the two main
// blocks' ds planes (16 B per element) and a few plane values the L2 serves,
// and does ~140 float operations per element (three ds adds per component
// and stream, two ds multiplies, one ds add).  The output is written once
// per group (and the running sum read once).
//
// What the design does about it:
//  - every pointer arrives in one table (HPtrs, copied from the host and
//    passed by value), so the wrapper stacks and copies nothing;
//  - a thread owns a run of R consecutive z elements of one (jx, jy) row
//    of one group: pz and the x/y signs are constant along the run and read
//    once, the rest as float4 (R = 4) or float2 (R = 2) where Nz % R == 0
//    and every pointer is aligned, element by element with a ragged tail
//    otherwise; offsets are 32-bit (the entry refuses sizes past 2^31);
//  - the node loop is unrolled by two, so the next node's loads are issued
//    before the current node's ds arithmetic (measured against a register
//    double buffer, 255 registers at R = 4, and a plain loop: the unrolled
//    loop was the fastest or within the noise of it at 32^3 and 64^3);
//  - the run length and block size come from the wrapper's plan
//    (kernels.oz_hadamard.plan): the longest run whose grid still gives two
//    blocks for each of the card's SMs.
// Each element sums its nodes in order from the group's first node, then
// adds acc: bitwise equal to the plain version, and to itself run to run.
//
// The entry point returns cudaGetLastError() of its launch; it launches on
// the given stream, does not synchronise and allocates nothing.

#include <stddef.h>
#include <string.h>

#include "oz_common.cuh"

namespace {

using bfft_oz::ds_add;
using bfft_oz::ds_mul;

// The operands, in the order of the wrapper's pointer table.
struct HPtrs {
  const float* r[2][2];     // main blocks [stream][hi, lo]: (C, Nx, Ny, Nz)
  const float* p[2][3][4];  // planes [stream][x, y, z][re hi, re lo, im hi, im lo]:
                            //   (C, Ny, Nz), (C, Nx, Nz), (C, Nx, Ny)
  const float* s[3];        // (-1)^n along x, y, z
  const float* w[2];        // (C,) hi, lo; or null
  const float* acc[2];      // running sum (groups, Nx, Ny, Nz) hi, lo; or null
  float* out[2];            // (groups, Nx, Ny, Nz) hi, lo
};
// The table's slots, as the wrapper numbers them (kernels.oz_hadamard.SLOT_*)
enum Slot { kPlanes = 4, kSigns = 28, kW = 31, kAcc = 33, kOut = 35, kNumPtrs = 37 };
static_assert(offsetof(HPtrs, p) == kPlanes * sizeof(void*) &&
                  offsetof(HPtrs, s) == kSigns * sizeof(void*) &&
                  offsetof(HPtrs, w) == kW * sizeof(void*) &&
                  offsetof(HPtrs, acc) == kAcc * sizeof(void*) &&
                  offsetof(HPtrs, out) == kOut * sizeof(void*) &&
                  sizeof(HPtrs) == kNumPtrs * sizeof(void*),
              "the pointer table's layout");

struct HDims {
  int ns_pg, nx, ny, nz, runs, n3;
};

// R floats from p, of which n are in range (VEC: all R, one vector load)
template <int R, bool VEC>
__device__ __forceinline__ void load_run(const float* __restrict__ p, int n, float (&v)[R]) {
  if constexpr (VEC && R == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (VEC && R == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = q.x;
    v[1] = q.y;
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] = i < n ? __ldg(p + i) : 0.0f;
  }
}

template <int R, bool VEC>
__device__ __forceinline__ void store_run(float* p, int n, const float (&v)[R]) {
  if constexpr (VEC && R == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC && R == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (i < n) p[i] = v[i];
  }
}

// One node's operands for one run, both streams
template <int R>
struct Node {
  float r[2][2][R];       // [stream][hi, lo][element]
  float pxy[2][2][4][R];  // [stream][x, y][component][element]
  float pz[2][4];         // [stream][component]: constant along the run
};

// Offsets of a run's first element at node 0: the main block's (and the
// output's within a group), px's, py's and pz's
struct RunAt {
  int e, x, y, z;
};

template <int R, bool VEC>
__device__ __forceinline__ void load_node(const HPtrs& a, const HDims& d, const RunAt& at,
                                          int j, int n, Node<R>& v) {
  const int e = j * d.n3 + at.e;
  const int x = j * (d.ny * d.nz) + at.x;
  const int y = j * (d.nx * d.nz) + at.y;
  const int z = j * (d.nx * d.ny) + at.z;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    load_run<R, VEC>(a.r[s][0] + e, n, v.r[s][0]);
    load_run<R, VEC>(a.r[s][1] + e, n, v.r[s][1]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      load_run<R, VEC>(a.p[s][0][k] + x, n, v.pxy[s][0][k]);
      load_run<R, VEC>(a.p[s][1][k] + y, n, v.pxy[s][1][k]);
      v.pz[s][k] = __ldg(a.p[s][2][k] + z);
    }
  }
}

// Node j's term, summed into (sh, sl): the order of _assemble_g_half, ds.cmul's
// real part, the weight, the compensated add
template <int R>
__device__ __forceinline__ void add_node(const Node<R>& v, float sx, float sy,
                                         const float (&sz)[R], const HPtrs& a, int j,
                                         bool first, float (&sh)[R], float (&sl)[R]) {
  float wh = 0.0f, wl = 0.0f;
  if (a.w[0] != nullptr) {
    wh = __ldg(a.w[0] + j);
    wl = __ldg(a.w[1] + j);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float gre[2][2], gim[2][2];  // [stream][hi, lo]
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      float h = v.r[s][0][i], l = v.r[s][1][i];
      ds_add(h, l, sx * v.pxy[s][0][0][i], sx * v.pxy[s][0][1][i], h, l);
      float ih = sx * v.pxy[s][0][2][i], il = sx * v.pxy[s][0][3][i];
      ds_add(h, l, sy * v.pxy[s][1][0][i], sy * v.pxy[s][1][1][i], h, l);
      ds_add(ih, il, sy * v.pxy[s][1][2][i], sy * v.pxy[s][1][3][i], ih, il);
      ds_add(h, l, sz[i] * v.pz[s][0], sz[i] * v.pz[s][1], h, l);
      ds_add(ih, il, sz[i] * v.pz[s][2], sz[i] * v.pz[s][3], ih, il);
      gre[s][0] = h;
      gre[s][1] = l;
      gim[s][0] = ih;
      gim[s][1] = il;
    }
    float rrh, rrl, iih, iil, th, tl;
    ds_mul(gre[0][0], gre[0][1], gre[1][0], gre[1][1], rrh, rrl);
    ds_mul(gim[0][0], gim[0][1], gim[1][0], gim[1][1], iih, iil);
    ds_add(rrh, rrl, -iih, -iil, th, tl);
    if (a.w[0] != nullptr) ds_mul(th, tl, wh, wl, th, tl);
    if (first) {
      sh[i] = th;
      sl[i] = tl;
    } else {
      ds_add(sh[i], sl[i], th, tl, sh[i], sl[i]);
    }
  }
}

// A thread: one run of R z elements of row (jx, jy) of group blockIdx.y
template <int R, bool VEC>
__global__ void __launch_bounds__(256)
    hwh_kernel(const __grid_constant__ HPtrs a, const __grid_constant__ HDims d) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= d.nx * d.ny * d.runs) return;
  const int g = blockIdx.y;
  const int row = t / d.runs;  // jx * Ny + jy
  const int z0 = (t - row * d.runs) * R;
  const int jx = row / d.ny;
  const int jy = row - jx * d.ny;
  const int n = min(R, d.nz - z0);  // R, or fewer in a ragged last run
  const RunAt at{row * d.nz + z0, jy * d.nz + z0, jx * d.nz + z0, row};
  const float sx = __ldg(a.s[0] + jx), sy = __ldg(a.s[1] + jy);
  float sz[R];
  load_run<R, VEC>(a.s[2] + z0, n, sz);
  const int j0 = g * d.ns_pg, j1 = j0 + d.ns_pg;
  float sh[R], sl[R];
  // unrolled by two: nothing is stored in the loop, so the compiler issues
  // the second node's loads ahead of the first node's arithmetic
#pragma unroll 2
  for (int j = j0; j < j1; ++j) {
    Node<R> v;
    load_node<R, VEC>(a, d, at, j, n, v);
    add_node<R>(v, sx, sy, sz, a, j, j == j0, sh, sl);
  }
  const int o = g * d.n3 + at.e;
  if (a.acc[0] != nullptr) {
    float ah[R], al[R];
    load_run<R, VEC>(a.acc[0] + o, n, ah);
    load_run<R, VEC>(a.acc[1] + o, n, al);
#pragma unroll
    for (int i = 0; i < R; ++i) ds_add(ah[i], al[i], sh[i], sl[i], sh[i], sl[i]);
  }
  store_run<R, VEC>(a.out[0] + o, n, sh);
  store_run<R, VEC>(a.out[1] + o, n, sl);
}

template <int R, bool VEC>
cudaError_t launch(const HPtrs& a, const HDims& d, int groups, int threads, cudaStream_t st) {
  const long long per_group = (long long)d.nx * d.ny * d.runs;
  const dim3 grid((unsigned)((per_group + threads - 1) / threads), (unsigned)groups);
  hwh_kernel<R, VEC><<<grid, threads, 0, st>>>(a, d);
  return cudaGetLastError();
}

bool aligned(const void* p, int bytes) { return ((uintptr_t)p) % bytes == 0; }

}  // namespace

// ptrs: the host table of 37 pointers (HPtrs' order), every operand
// contiguous; run: R, the z elements a thread (1, 2 or 4); threads: the
// block size; both from the wrapper's plan.
extern "C" int bfft_oz_hadamard_half(const void* ptrs, int c, int groups, int nx, int ny,
                                     int nz, int run, int threads, void* stream) {
  if (ptrs == nullptr || c < 1 || groups < 1 || c % groups || groups > 65535 || nx < 1 ||
      ny < 1 || nz < 1 || (run != 1 && run != 2 && run != 4) || threads < 32 ||
      threads > 256 || threads % 32)
    return cudaErrorInvalidValue;
  const long long n3 = (long long)nx * ny * nz;
  if ((long long)c * n3 >= (1LL << 31) || (long long)groups * n3 >= (1LL << 31))
    return cudaErrorInvalidValue;  // 32-bit offsets
  HPtrs a;
  memcpy(&a, ptrs, sizeof(a));
  const void* const* all = reinterpret_cast<const void* const*>(&a);
  for (int i = 0; i < kW; ++i)  // main blocks, planes, signs: all required
    if (all[i] == nullptr) return cudaErrorInvalidValue;
  if ((a.w[0] == nullptr) != (a.w[1] == nullptr) ||
      (a.acc[0] == nullptr) != (a.acc[1] == nullptr) || a.out[0] == nullptr ||
      a.out[1] == nullptr)
    return cudaErrorInvalidValue;
  // vector loads: whole runs, and every pointer read or written along z
  // aligned (all but pz's four, the x and y signs and the weights)
  bool vec = run > 1 && nz % run == 0;
  auto along_z = [&](const void* p) {
    if (p != nullptr && !aligned(p, 4 * run)) vec = false;
  };
  for (int s = 0; s < 2; ++s)
    for (int k = 0; k < 4; ++k) {
      along_z(a.p[s][0][k]);
      along_z(a.p[s][1][k]);
      if (k < 2) along_z(a.r[s][k]);
    }
  along_z(a.s[2]);
  for (int k = 0; k < 2; ++k) {
    along_z(a.acc[k]);
    along_z(a.out[k]);
  }
  const HDims d{c / groups, nx, ny, nz, (nz + run - 1) / run, (int)n3};
  const cudaStream_t st = (cudaStream_t)stream;
  if (run == 4) return vec ? launch<4, true>(a, d, groups, threads, st)
                           : launch<4, false>(a, d, groups, threads, st);
  if (run == 2) return vec ? launch<2, true>(a, d, groups, threads, st)
                           : launch<2, false>(a, d, groups, threads, st);
  return launch<1, false>(a, d, groups, threads, st);
}
