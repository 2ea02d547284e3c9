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
// What the design does about it: one thread per output element walks the C
// nodes in order with the sum in registers (no atomics, no second pass,
// bitwise reproducible), and the output is written once.  The streams are
// read in place through their strides (node, then three per-node axes): the
// full routes hand over the x stage's rolled views, and a copy of the eight
// planes into order would cost more than the kernel.  The wrapper orders
// the three axes as the first stream lies in memory, so consecutive threads
// read consecutive elements of its planes (and of the second stream's, on
// the routes, which lay both out alike); only the four output planes are
// written through strides.  The TPU kernel's node grid axis with output-block revisiting, and its
// 128-lane tiling rule (the jnp twin where the grid does not tile), have no
// counterpart: every shape runs the kernel.
//
// The entry point returns cudaGetLastError() of its launch; it launches on
// the given stream, does not synchronise and allocates nothing.

#include "oz_common.cuh"

namespace {

using bfft_oz::ds_add;
using bfft_oz::ds_mul;

struct HArgs {
  const float *g1rh, *g1rl, *g1ih, *g1il;  // (C, d1, d2, d3), strides s1
  const float *g2rh, *g2rl, *g2ih, *g2il;  // (C, d1, d2, d3), strides s2
  const float *wh, *wl;                    // (C,) or null
  float *orh, *orl, *oih, *oil;            // (d1, d2, d3), strides so
  int c, d1, d2, d3;
  long long s1[4], s2[4], so[3];  // element strides: node, axes 1, 2, 3
};

__global__ void hadamard_wsum_kernel(const HArgs a) {
  const long long n = (long long)a.d1 * a.d2 * a.d3;
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= n) return;
  const long long i3 = e % a.d3, q = e / a.d3, i2 = q % a.d2, i1 = q / a.d2;
  const long long b1 = i1 * a.s1[1] + i2 * a.s1[2] + i3 * a.s1[3];
  const long long b2 = i1 * a.s2[1] + i2 * a.s2[2] + i3 * a.s2[3];
  const long long oe = i1 * a.so[0] + i2 * a.so[1] + i3 * a.so[2];
  float srh = 0.0f, srl = 0.0f, sih = 0.0f, sil = 0.0f;
  for (int j = 0; j < a.c; ++j) {
    const long long o1 = b1 + j * a.s1[0], o2 = b2 + j * a.s2[0];
    const float arh = a.g1rh[o1], arl = a.g1rl[o1], aih = a.g1ih[o1], ail = a.g1il[o1];
    const float brh = a.g2rh[o2], brl = a.g2rl[o2], bih = a.g2ih[o2], bil = a.g2il[o2];
    float rrh, rrl, iih, iil, rih, ril, irh, irl, trh, trl, tih, til;
    ds_mul(arh, arl, brh, brl, rrh, rrl);
    ds_mul(aih, ail, bih, bil, iih, iil);
    ds_mul(arh, arl, bih, bil, rih, ril);
    ds_mul(aih, ail, brh, brl, irh, irl);
    ds_add(rrh, rrl, -iih, -iil, trh, trl);
    ds_add(rih, ril, irh, irl, tih, til);
    if (a.wh != nullptr) {
      const float wh = a.wh[j], wl = a.wl[j];
      ds_mul(trh, trl, wh, wl, trh, trl);
      ds_mul(tih, til, wh, wl, tih, til);
    }
    if (j == 0) {
      srh = trh;
      srl = trl;
      sih = tih;
      sil = til;
    } else {
      ds_add(srh, srl, trh, trl, srh, srl);
      ds_add(sih, sil, tih, til, sih, sil);
    }
  }
  a.orh[oe] = srh;
  a.orl[oe] = srl;
  a.oih[oe] = sih;
  a.oil[oe] = sil;
}

}  // namespace

extern "C" int bfft_oz_hadamard(const void* g1rh, const void* g1rl, const void* g1ih,
                                const void* g1il, const void* g2rh, const void* g2rl,
                                const void* g2ih, const void* g2il, const void* wh,
                                const void* wl, void* orh, void* orl, void* oih, void* oil,
                                int c, int d1, int d2, int d3, int s10, int s11, int s12,
                                int s13, int s20, int s21, int s22, int s23, int so1,
                                int so2, int so3, void* stream) {
  if (c < 1 || d1 < 1 || d2 < 1 || d3 < 1 || (wh == nullptr) != (wl == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const int s1[4] = {s10, s11, s12, s13}, s2[4] = {s20, s21, s22, s23};
  const int so[3] = {so1, so2, so3};
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
  a.d1 = d1;
  a.d2 = d2;
  a.d3 = d3;
  for (int i = 0; i < 4; ++i) {
    if (s1[i] < 0 || s2[i] < 0) return cudaErrorInvalidValue;
    a.s1[i] = s1[i];
    a.s2[i] = s2[i];
  }
  for (int i = 0; i < 3; ++i) {
    if (so[i] < 0) return cudaErrorInvalidValue;
    a.so[i] = so[i];
  }
  const int pt = 256;
  const long long blocks = ((long long)d1 * d2 * d3 + pt - 1) / pt;
  hadamard_wsum_kernel<<<(unsigned)blocks, pt, 0, (cudaStream_t)stream>>>(a);
  return cudaGetLastError();
}
