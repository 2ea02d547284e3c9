// DMMA throughput probe for one card: how fast mma.sync runs in float64 in
// each shape K1 uses, with everything in registers.  Prints TFLOP/s for
// independent m16n8k16 chains (1 and 4 a warp), m8n8k4 chains (8 a warp,
// the dense tiles' shape) and the split's pair chain (two m16n8k16 stage-1
// products, the twiddle, two stage-2 products), at several block sizes, two
// blocks an SM.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//        -o build/dmma_probe tools/dmma_probe.cu && build/dmma_probe
#include <cstdio>
#include <cuda_runtime.h>
__device__ __forceinline__ void k16(double (&d)[4], const double (&a)[8], const double (&b)[4]) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
        "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}
__device__ __forceinline__ void k8(double (&d)[4], const double (&a)[4], const double (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
__device__ __forceinline__ void k4(double (&d)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1]) : "d"(a), "d"(b));
}
template <int C>
__global__ void indep16(double* out, int iters) {
  double a[8], b[4], d[C][4];
  for (int i = 0; i < 8; ++i) a[i] = threadIdx.x * 1e-3 + i;
  for (int i = 0; i < 4; ++i) b[i] = threadIdx.x * 1e-4 + i;
  for (int c = 0; c < C; ++c) for (int r = 0; r < 4; ++r) d[c][r] = 0;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < C; ++c) k16(d[c], a, b);
  double s = 0;
  for (int c = 0; c < C; ++c) for (int r = 0; r < 4; ++r) s += d[c][r];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int C>
__global__ void indep4(double* out, int iters) {
  double a = threadIdx.x * 1e-3, b = threadIdx.x * 1e-4, d[C][2];
  for (int c = 0; c < C; ++c) d[c][0] = d[c][1] = 0;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < C; ++c) k4(d[c], a, b);
  double s = 0;
  for (int c = 0; c < C; ++c) s += d[c][0] + d[c][1];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// the split pair's chain from registers: 2 x stage 1 (k16), twiddle, 2 x stage 2 (k16)
__global__ void pairchain(double* out, int iters) {
  double a1[8], b2re[4], b2im[4], twr[2], twi[2];
  for (int i = 0; i < 8; ++i) a1[i] = 0.1 * i + threadIdx.x * 1e-5;
  for (int i = 0; i < 4; ++i) { b2re[i] = 0.01 * i; b2im[i] = 0.02 * i; }
  twr[0] = 0.9; twr[1] = 0.8; twi[0] = 0.1; twi[1] = 0.2;
  double x[2][4];
  for (int q = 0; q < 2; ++q) for (int i = 0; i < 4; ++i) x[q][i] = 1e-3 * (i + q + threadIdx.x);
  for (int it = 0; it < iters; ++it) {
    double c[2][4];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      c[q][0] = c[q][1] = c[q][2] = c[q][3] = 0;
      k16(c[q], a1, x[q]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const double yr = c[q][h], yi = c[q][2 + h];
        c[q][h] = twr[h] * yr - twi[h] * yi;
        c[q][2 + h] = twr[h] * yi + twi[h] * yr;
      }
    }
    const double a[8] = {c[0][0], c[1][0], c[0][1], c[1][1], c[0][2], c[1][2], c[0][3], c[1][3]};
    double orr[4] = {0, 0, 0, 0}, oi[4] = {0, 0, 0, 0};
    k16(orr, a, b2re);
    k16(oi, a, b2im);
    for (int i = 0; i < 4; ++i) { x[0][i] = orr[i] * 0.5; x[1][i] = oi[i] * 0.5; }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = x[0][0] + x[1][1];
}
template <class K>
void run(const char* name, K kern, int blocks, int threads, int iters, double flop_per_warp_iter) {
  double* out; cudaMalloc(&out, sizeof(double) * blocks * threads);
  kern<<<blocks, threads>>>(out, 10); cudaDeviceSynchronize();
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  cudaEventRecord(a); kern<<<blocks, threads>>>(out, iters); cudaEventRecord(b);
  cudaEventSynchronize(b); float ms; cudaEventElapsedTime(&ms, a, b);
  double flops = flop_per_warp_iter * iters * (double)blocks * threads / 32;
  printf("%-28s blocks %4d threads %4d: %.3f ms, %.2f TFLOP/s (err %s)\n", name, blocks, threads, ms,
         flops / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
}
int main() {
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const double f16 = 2.0 * 16 * 8 * 16, f4 = 2.0 * 8 * 8 * 4;
  for (int w : {4, 8, 16, 32}) run("m16n8k16, 1 chain a warp", indep16<1>, sms * 2, w * 16, 4000, f16);
  for (int w : {4, 8, 16}) run("m16n8k16, 4 chains a warp", indep16<4>, sms * 2, w * 16, 1000, 4 * f16);
  for (int w : {8, 16}) {
    run("m8n8k4, 8 chains a warp", indep4<8>, sms * 2, w * 16, 4000, 8 * f4);
    run("the split's pair chain", pairchain, sms * 2, w * 16, 2000, 4 * f16);
  }
  return 0;
}
