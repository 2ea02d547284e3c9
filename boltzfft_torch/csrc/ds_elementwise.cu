// The ds engine's elementwise chains for Hopper: each double-single (ds)
// operator of boltzfft_torch/ds.py, and the three compositions its call
// sites make, as one grid-stride kernel, for float and double pairs.
//
// No TPU kernel stands behind these.  The JAX package pins every
// intermediate of its error-free transforms with lax.reduce_precision
// (boltzfft/ds.py::_opaque) so that XLA can fuse each chain into one loop
// under jit without breaking its rounding; eager PyTorch runs the same
// chain as 6 (two_sum) to ~118 (cmul) separate kernels.  These kernels are
// the card's counterpart of XLA's loop fusions: the chain of ds.py, operand
// order included, per element, in one launch.
//
// Bits: every +, - and * goes through the round-to-nearest intrinsics
// (__fadd_rn, __fsub_rn, __fmul_rn and their __d*_rn twins), which nvcc
// never contracts into an FMA, and the file is compiled with --fmad=false
// besides (_build.FILE_FLAGS); no flag flushes denormals.  So each element
// is rounded exactly as PyTorch's separate elementwise kernels round it,
// and the result is bitwise that of the plain chain.
//
// Operands: up to kMaxIn input planes (the hi and lo words of each ds
// operand; a sign pattern for the signed folds), each with its own element
// strides over up to kMaxDims output dims, stride 0 on a broadcast dim, so
// no operand is expanded or copied.  The wrapper (kernels/ds_elementwise.py)
// merges dims that every operand walks contiguously, so a contiguous or
// scalar-broadcast operand set is one dim and no index is divided.  The
// outputs are contiguous planes of the broadcast shape.
//
// What bounds it on this card: bytes (a ds multiply is ~25 flops on 16
// bytes in and 8 out in float).  A thread takes one element per step of a
// grid-stride loop; 32-bit index arithmetic where every offset fits.
//
// The entry point returns cudaGetLastError() of its launch; it launches on
// the given stream, does not synchronise and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxIn = 10;
constexpr int kMaxOut = 8;
constexpr int kMaxDims = 6;
constexpr int kThreads = 256;

// The wrapper's table, all 64-bit words: input and output addresses, the
// merged output sizes (outermost first), each input's element strides, the
// element count and the number of dims.
struct EwArgs {
  long long in[kMaxIn];
  long long out[kMaxOut];
  long long size[kMaxDims];
  long long stride[kMaxIn][kMaxDims];
  long long n;
  long long ndim;
};
static_assert(sizeof(EwArgs) == (kMaxIn + kMaxOut + kMaxDims + kMaxIn * kMaxDims + 2) * 8,
              "the table's layout");

// ---- rounded arithmetic, float and double -------------------------------

template <typename T>
struct Rn;

template <>
struct Rn<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static constexpr float kSplit = 4097.0f;  // 2^12 + 1: Dekker's constant, 24-bit mantissa
};

template <>
struct Rn<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static constexpr double kSplit = 134217729.0;  // 2^27 + 1, 53-bit mantissa
};

// ---- the error-free transforms of ds.py, op for op ----------------------

// s + e == a + b exactly (ds.two_sum)
template <typename T>
__device__ __forceinline__ void two_sum(T a, T b, T& s, T& e) {
  using R = Rn<T>;
  s = R::add(a, b);
  const T bb = R::sub(s, a);
  e = R::add(R::sub(a, R::sub(s, bb)), R::sub(b, bb));
}

// two_sum for |a| >= |b| (ds.quick_two_sum)
template <typename T>
__device__ __forceinline__ void quick_two_sum(T a, T b, T& s, T& e) {
  using R = Rn<T>;
  s = R::add(a, b);
  e = R::sub(b, R::sub(s, a));
}

// a == h + l, each with half the mantissa (ds.split)
template <typename T>
__device__ __forceinline__ void split(T a, T& h, T& l) {
  using R = Rn<T>;
  const T c = R::mul(a, R::kSplit);
  h = R::sub(c, R::sub(c, a));
  l = R::sub(a, h);
}

// p + e == a * b exactly (ds.two_prod):
// e = ((ah*bh - p) + ah*bl + al*bh) + al*bl
template <typename T>
__device__ __forceinline__ void two_prod(T a, T b, T& p, T& e) {
  using R = Rn<T>;
  p = R::mul(a, b);
  T ah, al, bh, bl;
  split(a, ah, al);
  split(b, bh, bl);
  e = R::add(R::add(R::add(R::sub(R::mul(ah, bh), p), R::mul(ah, bl)), R::mul(al, bh)),
             R::mul(al, bl));
}

// ds.add: two_sum of the high words, e + (lo + lo), quick_two_sum
template <typename T>
__device__ __forceinline__ void ds_add(T xh, T xl, T yh, T yl, T& sh, T& sl) {
  using R = Rn<T>;
  T s, e;
  two_sum(xh, yh, s, e);
  e = R::add(e, R::add(xl, yl));
  quick_two_sum(s, e, sh, sl);
}

// ds.sub = ds.add(x, ds.neg(y)); the negation is exact
template <typename T>
__device__ __forceinline__ void ds_sub(T xh, T xl, T yh, T yl, T& sh, T& sl) {
  ds_add(xh, xl, -yh, -yl, sh, sl);
}

// ds.mul: two_prod of the high words, e + (xh*yl + xl*yh), quick_two_sum
template <typename T>
__device__ __forceinline__ void ds_mul(T xh, T xl, T yh, T yl, T& ph, T& pl) {
  using R = Rn<T>;
  T p, e;
  two_prod(xh, yh, p, e);
  e = R::add(e, R::add(R::mul(xh, yl), R::mul(xl, yh)));
  quick_two_sum(p, e, ph, pl);
}

// ds.mul_f: a ds times a plain float
template <typename T>
__device__ __forceinline__ void ds_mul_f(T xh, T xl, T a, T& ph, T& pl) {
  using R = Rn<T>;
  T p, e;
  two_prod(xh, a, p, e);
  e = R::add(e, R::mul(xl, a));
  quick_two_sum(p, e, ph, pl);
}

// ds.cmul: (xr yr - xi yi, xr yi + xi yr), each product a ds.mul
template <typename T>
__device__ __forceinline__ void ds_cmul(const T* x, const T* y, T* o) {
  T rr[2], ii[2], ri[2], ir[2];
  ds_mul(x[0], x[1], y[0], y[1], rr[0], rr[1]);
  ds_mul(x[2], x[3], y[2], y[3], ii[0], ii[1]);
  ds_mul(x[0], x[1], y[2], y[3], ri[0], ri[1]);
  ds_mul(x[2], x[3], y[0], y[1], ir[0], ir[1]);
  ds_sub(rr[0], rr[1], ii[0], ii[1], o[0], o[1]);
  ds_add(ri[0], ri[1], ir[0], ir[1], o[2], o[3]);
}

// ---- the entries' element functions: inputs v, outputs o ------------------
// Planes in the wrapper's order: a ds operand as (hi, lo), a complex one as
// (re hi, re lo, im hi, im lo).

template <typename T>
struct Add {  // ds.add(x, y)
  static constexpr int kIn = 4, kOut = 2;
  static __device__ __forceinline__ void apply(const T* v, T* o) {
    ds_add(v[0], v[1], v[2], v[3], o[0], o[1]);
  }
};

template <typename T>
struct Sub {  // ds.sub(x, y)
  static constexpr int kIn = 4, kOut = 2;
  static __device__ __forceinline__ void apply(const T* v, T* o) {
    ds_sub(v[0], v[1], v[2], v[3], o[0], o[1]);
  }
};

template <typename T>
struct Mul {  // ds.mul(x, y)
  static constexpr int kIn = 4, kOut = 2;
  static __device__ __forceinline__ void apply(const T* v, T* o) {
    ds_mul(v[0], v[1], v[2], v[3], o[0], o[1]);
  }
};

template <typename T>
struct MulF {  // ds.mul_f(x, a)
  static constexpr int kIn = 3, kOut = 2;
  static __device__ __forceinline__ void apply(const T* v, T* o) {
    ds_mul_f(v[0], v[1], v[2], o[0], o[1]);
  }
};

template <typename T>
struct Cadd {  // ds.cadd(x, y)
  static constexpr int kIn = 8, kOut = 4;
  static __device__ __forceinline__ void apply(const T* v, T* o) {
    ds_add(v[0], v[1], v[4], v[5], o[0], o[1]);
    ds_add(v[2], v[3], v[6], v[7], o[2], o[3]);
  }
};

template <typename T>
struct Cmul {  // ds.cmul(x, y)
  static constexpr int kIn = 8, kOut = 4;
  static __device__ __forceinline__ void apply(const T* v, T* o) { ds_cmul(v, v + 4, o); }
};

template <typename T>
struct CmulDs {  // ds.cmul_ds(x, w)
  static constexpr int kIn = 6, kOut = 4;
  static __device__ __forceinline__ void apply(const T* v, T* o) {
    ds_mul(v[0], v[1], v[4], v[5], o[0], o[1]);
    ds_mul(v[2], v[3], v[4], v[5], o[2], o[3]);
  }
};

template <typename T>
struct CmulBoth {  // ds.cmul_both(a, f): (a f, conj(a) f) from the same four products
  static constexpr int kIn = 8, kOut = 8;
  static __device__ __forceinline__ void apply(const T* v, T* o) {
    T rr[2], ii[2], ri[2], ir[2];
    ds_mul(v[0], v[1], v[4], v[5], rr[0], rr[1]);
    ds_mul(v[2], v[3], v[6], v[7], ii[0], ii[1]);
    ds_mul(v[0], v[1], v[6], v[7], ri[0], ri[1]);
    ds_mul(v[2], v[3], v[4], v[5], ir[0], ir[1]);
    ds_sub(rr[0], rr[1], ii[0], ii[1], o[0], o[1]);
    ds_add(ri[0], ri[1], ir[0], ir[1], o[2], o[3]);
    ds_add(rr[0], rr[1], ii[0], ii[1], o[4], o[5]);
    ds_sub(ri[0], ri[1], ir[0], ir[1], o[6], o[7]);
  }
};

template <typename T>
struct Axpy {  // ds.axpy(f, k, s) = ds.add(f, ds.mul(k, s)): RK's f + a k
  static constexpr int kIn = 6, kOut = 2;
  static __device__ __forceinline__ void apply(const T* v, T* o) {
    T p[2];
    ds_mul(v[2], v[3], v[4], v[5], p[0], p[1]);
    ds_add(v[0], v[1], p[0], p[1], o[0], o[1]);
  }
};

template <typename T>
struct Caxpy {  // ds.caxpy(acc, x, w) = ds.cadd(acc, ds.cmul_ds(x, w))
  static constexpr int kIn = 10, kOut = 4;
  static __device__ __forceinline__ void apply(const T* v, T* o) {
    T re[2], im[2];
    ds_mul(v[4], v[5], v[8], v[9], re[0], re[1]);
    ds_mul(v[6], v[7], v[8], v[9], im[0], im[1]);
    ds_add(v[0], v[1], re[0], re[1], o[0], o[1]);
    ds_add(v[2], v[3], im[0], im[1], o[2], o[3]);
  }
};

template <typename T>
struct SubMul {  // ds.sub_mul(a, b, c) = ds.sub(a, ds.mul(b, c))
  static constexpr int kIn = 6, kOut = 2;
  static __device__ __forceinline__ void apply(const T* v, T* o) {
    T p[2];
    ds_mul(v[2], v[3], v[4], v[5], p[0], p[1]);
    ds_sub(v[0], v[1], p[0], p[1], o[0], o[1]);
  }
};

template <typename T>
struct CaddSigned {  // ds.cadd_signed(p, t, s) = ds.cadd(p, t * s), s a sign pattern
  static constexpr int kIn = 9, kOut = 4;
  static __device__ __forceinline__ void apply(const T* v, T* o) {
    using R = Rn<T>;
    const T s = v[8];
    ds_add(v[0], v[1], R::mul(v[4], s), R::mul(v[5], s), o[0], o[1]);
    ds_add(v[2], v[3], R::mul(v[6], s), R::mul(v[7], s), o[2], o[3]);
  }
};

template <typename T>
struct AddSigned {  // ds.add_signed(p, t, s) = ds.add(p, t * s)
  static constexpr int kIn = 5, kOut = 2;
  static __device__ __forceinline__ void apply(const T* v, T* o) {
    using R = Rn<T>;
    ds_add(v[0], v[1], R::mul(v[2], v[4]), R::mul(v[3], v[4]), o[0], o[1]);
  }
};

// ---- the kernel ----------------------------------------------------------

// Element i of the output (row-major over the merged sizes): each input
// read through its strides, the chain applied, each output plane written at i.
template <typename T, template <typename> class Op, typename Idx>
__global__ void __launch_bounds__(kThreads) ds_elementwise_kernel(const __grid_constant__ EwArgs a) {
  using F = Op<T>;
  const Idx n = (Idx)a.n;
  const int nd = (int)a.ndim;
  const Idx step = (Idx)gridDim.x * kThreads;
  for (Idx i = (Idx)blockIdx.x * kThreads + threadIdx.x; i < n; i += step) {
    Idx off[F::kIn];
#pragma unroll
    for (int k = 0; k < F::kIn; ++k) off[k] = 0;
    Idx rem = i;
#pragma unroll
    for (int d = kMaxDims - 1; d >= 1; --d) {
      if (d < nd) {
        const Idx sz = (Idx)a.size[d];
        const Idx q = rem / sz;
        const Idx c = rem - q * sz;
        rem = q;
#pragma unroll
        for (int k = 0; k < F::kIn; ++k) off[k] += c * (Idx)a.stride[k][d];
      }
    }
#pragma unroll
    for (int k = 0; k < F::kIn; ++k) off[k] += rem * (Idx)a.stride[k][0];  // the outermost dim
    T v[F::kIn], o[F::kOut];
#pragma unroll
    for (int k = 0; k < F::kIn; ++k) v[k] = __ldg(reinterpret_cast<const T*>(a.in[k]) + off[k]);
    F::apply(v, o);
#pragma unroll
    for (int k = 0; k < F::kOut; ++k) reinterpret_cast<T*>(a.out[k])[i] = o[k];
  }
}

// The entry's op codes (kernels.ds_elementwise.OPS)
enum OpCode {
  kAdd, kSub, kMul, kMulF, kCadd, kCmul, kCmulDs, kCmulBoth,
  kAxpy, kCaxpy, kSubMul, kCaddSigned, kAddSigned, kNumOps
};

template <typename T, template <typename> class Op>
cudaError_t launch(const EwArgs& a, bool wide, int blocks, cudaStream_t st) {
  for (int k = 0; k < Op<T>::kIn; ++k)
    if (a.in[k] == 0) return cudaErrorInvalidValue;
  for (int k = 0; k < Op<T>::kOut; ++k)
    if (a.out[k] == 0) return cudaErrorInvalidValue;
  if (wide)
    ds_elementwise_kernel<T, Op, long long><<<blocks, kThreads, 0, st>>>(a);
  else
    ds_elementwise_kernel<T, Op, int><<<blocks, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int op, const EwArgs& a, bool wide, int blocks, cudaStream_t st) {
  switch (op) {
    case kAdd: return launch<T, Add>(a, wide, blocks, st);
    case kSub: return launch<T, Sub>(a, wide, blocks, st);
    case kMul: return launch<T, Mul>(a, wide, blocks, st);
    case kMulF: return launch<T, MulF>(a, wide, blocks, st);
    case kCadd: return launch<T, Cadd>(a, wide, blocks, st);
    case kCmul: return launch<T, Cmul>(a, wide, blocks, st);
    case kCmulDs: return launch<T, CmulDs>(a, wide, blocks, st);
    case kCmulBoth: return launch<T, CmulBoth>(a, wide, blocks, st);
    case kAxpy: return launch<T, Axpy>(a, wide, blocks, st);
    case kCaxpy: return launch<T, Caxpy>(a, wide, blocks, st);
    case kSubMul: return launch<T, SubMul>(a, wide, blocks, st);
    case kCaddSigned: return launch<T, CaddSigned>(a, wide, blocks, st);
    case kAddSigned: return launch<T, AddSigned>(a, wide, blocks, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// op: the chain (OpCode); is_f64: double pairs, else float; args: the
// host table (EwArgs' layout, 64-bit words); blocks: the grid (the
// wrapper's, at most a few per SM: the loop strides over the rest).
extern "C" int bfft_ds_elementwise(int op, int is_f64, const void* args, int blocks,
                                   void* stream) {
  if (args == nullptr || op < 0 || op >= kNumOps || blocks < 1) return cudaErrorInvalidValue;
  EwArgs a;
  memcpy(&a, args, sizeof(a));
  if (a.n < 1 || a.ndim < 1 || a.ndim > kMaxDims) return cudaErrorInvalidValue;
  // 32-bit indices where the element count and every offset fit
  long long reach = a.n;
  for (int k = 0; k < kMaxIn; ++k) {
    long long last = 0;
    for (int d = 0; d < a.ndim; ++d) {
      if (a.size[d] < 1 || a.stride[k][d] < 0) return cudaErrorInvalidValue;
      last += (a.size[d] - 1) * a.stride[k][d];
    }
    if (last + 1 > reach) reach = last + 1;
  }
  const bool wide = reach >= (1LL << 31);
  const cudaStream_t st = (cudaStream_t)stream;
  return is_f64 ? dispatch<double>(op, a, wide, blocks, st)
                : dispatch<float>(op, a, wide, blocks, st);
}
