// K12 for Hopper: the half-spectrum Hadamard product and radial-group sum of
// the ds engine, Re sum_j w_j g1_j g2_j per group, float32 pairs.
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
// Only Re is formed: the pipeline's Re(IFFT(beta1 FFT(.))) annihilates Im.
//
// What bounds it on this card: bytes.  Per node it reads the two main
// blocks' ds planes (16 B per element) and a few plane values the L2 serves,
// and does ~80 float operations per element (three ds adds per component
// and stream, two ds multiplies, one ds add).  The output is written once
// per group.
//
// What the design does about it: one thread per output element of a group
// walks the group's nodes in order with the sum in registers (no atomics,
// no cross-block pass, bitwise reproducible); consecutive threads read
// consecutive main-block elements.  The TPU kernel's lane layout
// (_hwh_layout) and its selector matmuls exist for Mosaic's tiles and have
// no counterpart here.
//
// The entry point returns cudaGetLastError() of its launch; it launches on
// the given stream, does not synchronise and allocates nothing.

#include "oz_common.cuh"

namespace {

using bfft_oz::ds_add;
using bfft_oz::ds_mul;

struct HArgs {
  const float *r1h, *r1l, *r2h, *r2l;  // (C, Nx, Ny, Nz)
  const float *px, *py, *pz;           // (2 streams x [reh, rel, imh, iml], C, plane)
  const float *sx, *sy, *sz;           // (-1)^n per axis
  const float *wh, *wl;                // (C,) or null
  float *oh, *ol;                      // (groups, Nx, Ny, Nz)
  int c, groups, nx, ny, nz;
};

__global__ void hwh_kernel(const HArgs a) {
  const long long n3 = (long long)a.nx * a.ny * a.nz;
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const int g = blockIdx.y;
  if (e >= n3) return;
  const int jz = (int)(e % a.nz);
  const int jy = (int)((e / a.nz) % a.ny);
  const int jx = (int)(e / ((long long)a.nz * a.ny));
  const float sx = a.sx[jx], sy = a.sy[jy], sz = a.sz[jz];
  const long long pxs = (long long)a.c * a.ny * a.nz;  // component stride of each plane field
  const long long pys = (long long)a.c * a.nx * a.nz;
  const long long pzs = (long long)a.c * a.nx * a.ny;
  const int ns_pg = a.c / a.groups;
  float sh = 0.0f, sl = 0.0f;
  for (int j = g * ns_pg; j < (g + 1) * ns_pg; ++j) {
    const long long ix = ((long long)j * a.ny + jy) * a.nz + jz;
    const long long iy = ((long long)j * a.nx + jx) * a.nz + jz;
    const long long iz = ((long long)j * a.nx + jx) * a.ny + jy;
    float gre[2][2], gim[2][2];  // [stream][hi, lo]
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float* px = a.px + 4 * s * pxs;
      const float* py = a.py + 4 * s * pys;
      const float* pz = a.pz + 4 * s * pzs;
      float h = s ? a.r2h[j * n3 + e] : a.r1h[j * n3 + e];
      float l = s ? a.r2l[j * n3 + e] : a.r1l[j * n3 + e];
      ds_add(h, l, sx * px[ix], sx * px[pxs + ix], h, l);
      float ih = sx * px[2 * pxs + ix], il = sx * px[3 * pxs + ix];
      ds_add(h, l, sy * py[iy], sy * py[pys + iy], h, l);
      ds_add(ih, il, sy * py[2 * pys + iy], sy * py[3 * pys + iy], ih, il);
      ds_add(h, l, sz * pz[iz], sz * pz[pzs + iz], h, l);
      ds_add(ih, il, sz * pz[2 * pzs + iz], sz * pz[3 * pzs + iz], ih, il);
      gre[s][0] = h;
      gre[s][1] = l;
      gim[s][0] = ih;
      gim[s][1] = il;
    }
    float rrh, rrl, iih, iil, th, tl;
    ds_mul(gre[0][0], gre[0][1], gre[1][0], gre[1][1], rrh, rrl);
    ds_mul(gim[0][0], gim[0][1], gim[1][0], gim[1][1], iih, iil);
    ds_add(rrh, rrl, -iih, -iil, th, tl);
    if (a.wh != nullptr) ds_mul(th, tl, a.wh[j], a.wl[j], th, tl);
    if (j == g * ns_pg) {
      sh = th;
      sl = tl;
    } else {
      ds_add(sh, sl, th, tl, sh, sl);
    }
  }
  a.oh[g * n3 + e] = sh;
  a.ol[g * n3 + e] = sl;
}

}  // namespace

extern "C" int bfft_oz_hadamard_half(const void* r1h, const void* r1l, const void* r2h,
                                     const void* r2l, const void* px, const void* py,
                                     const void* pz, const void* sx, const void* sy,
                                     const void* sz, const void* wh, const void* wl,
                                     void* oh, void* ol, int c, int groups, int nx, int ny,
                                     int nz, void* stream) {
  if (c < 1 || groups < 1 || c % groups || groups > 65535 || nx < 1 || ny < 1 || nz < 1)
    return cudaErrorInvalidValue;
  HArgs a;
  a.r1h = (const float*)r1h;
  a.r1l = (const float*)r1l;
  a.r2h = (const float*)r2h;
  a.r2l = (const float*)r2l;
  a.px = (const float*)px;
  a.py = (const float*)py;
  a.pz = (const float*)pz;
  a.sx = (const float*)sx;
  a.sy = (const float*)sy;
  a.sz = (const float*)sz;
  a.wh = (const float*)wh;
  a.wl = (const float*)wl;
  a.oh = (float*)oh;
  a.ol = (float*)ol;
  a.c = c;
  a.groups = groups;
  a.nx = nx;
  a.ny = ny;
  a.nz = nz;
  const long long n3 = (long long)nx * ny * nz;
  const int pt = 256;
  const long long blocks = (n3 + pt - 1) / pt;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  hwh_kernel<<<dim3((unsigned)blocks, groups), pt, 0, (cudaStream_t)stream>>>(a);
  return cudaGetLastError();
}
