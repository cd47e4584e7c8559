// The execution component's k-source elementwise reduce, as one kernel
// launch.
//
// Replaces ucc_tpu/ec/tpu.py:_build_reduce_kernel (the Pallas kernel that
// EcTpu.reduce, reduce_strided and reduce_multi_dst run): k <= 9 sources
// of `count` elements fold into one vector,
//   dst = cast_T(alpha * fold_op(x_0, ..., x_{k-1})).
// The Pallas kernel stacks copies of the sources into (k, rows, 128) tiles;
// here every source is a pointer of its own (a strided source is a pointer
// into its base), so nothing is copied and any element offset is accepted.
//
// Rules (each one bitwise that of the plain PyTorch version in
// ucc_tpu_torch/kernels/ec_reduce.py, and of the Pallas kernel in
// interpret mode for every type it takes):
// - accumulator: float16 and bfloat16 load into float, fold in float and
//   round once at the end to nearest even; every other type folds in its
//   own width, integers wrapping (unsigned arithmetic, so no overflow is
//   undefined);
// - order: acc = x_0, then acc = op(acc, x_i) for i = 1..k-1, in source
//   order; float adds and multiplies are __fadd_rn/__fmul_rn (double:
//   __dadd_rn/__dmul_rn), which the compiler never contracts into an FMA;
// - MAX/MIN propagate NaN, as jnp.maximum does (fmaxf/fminf would drop
//   it): op(a, b) = (a > b or a is NaN) ? a : b, and likewise with <;
// - logical ops: x != 0 (in float for the half types) folded as bools,
//   then 1 or 0 in T. With k = 1 the 8-, 16- and 32-bit types return the
//   input unchanged, because the reference never booleanizes one source;
//   the 64-bit types follow ucc_tpu_torch/ec/cpu.py:reduce_arrays, which
//   does;
// - alpha: the accumulator goes to float (double for the 64-bit types),
//   is multiplied by alpha rounded to that type, and is cast back:
//   rounding to nearest even for floats, truncation toward zero for
//   integers. Without alpha AVG is SUM.
// Bitwise ops on floating types are refused by the wrapper.
//
// What bounds it: bytes. The least traffic is k reads and one write of
// count elements; there are at most 8 operations per element, far below
// the card's rate. This first version is plain: one element per thread of
// a grid-stride loop, scalar loads (safe at any alignment, as a strided
// source at an odd element offset needs), the k loop unrolled to 9 with a
// guard so the pointer array stays in parameter space. Vector loads with
// an alignment check, and keeping more loads in flight per thread, come
// in a later PR.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kMaxSrcs = 9;
constexpr int kThreads = 256;

struct ReduceArgs {
  const void* src[kMaxSrcs];
  void* dst;
  long long count;
  int k;
  int has_alpha;
  double alpha;
};

// ReductionOp values of ucc_tpu_torch/constants.py
enum Op {
  kSum = 0, kProd = 1, kMax = 2, kMin = 3, kLand = 4, kLor = 5, kLxor = 6,
  kBand = 7, kBor = 8, kBxor = 9, kAvg = 12
};

// the accumulator type
template <typename T> struct Acc { using type = T; };
template <> struct Acc<__half> { using type = float; };
template <> struct Acc<__nv_bfloat16> { using type = float; };

template <typename T>
__device__ __forceinline__ typename Acc<T>::type load(const T* p) {
  return *p;
}
template <>
__device__ __forceinline__ float load<__half>(const __half* p) {
  return __half2float(*p);
}
template <>
__device__ __forceinline__ float load<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// a float (or, for the 64-bit types, double) value to T
template <typename T, typename F>
__device__ __forceinline__ T from_float(F v) { return static_cast<T>(v); }
template <>
__device__ __forceinline__ __half from_float<__half, float>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16, float>(
    float v) {
  return __float2bfloat16_rn(v);
}

template <typename A>
__device__ __forceinline__ A add(A a, A b) {
  if constexpr (std::is_same_v<A, float>) {
    return __fadd_rn(a, b);
  } else if constexpr (std::is_same_v<A, double>) {
    return __dadd_rn(a, b);
  } else {
    using U = std::make_unsigned_t<A>;
    using W = std::conditional_t<sizeof(A) <= 4, unsigned, U>;
    return static_cast<A>(static_cast<U>(static_cast<W>(static_cast<U>(a)) +
                                         static_cast<W>(static_cast<U>(b))));
  }
}

template <typename A>
__device__ __forceinline__ A mul(A a, A b) {
  if constexpr (std::is_same_v<A, float>) {
    return __fmul_rn(a, b);
  } else if constexpr (std::is_same_v<A, double>) {
    return __dmul_rn(a, b);
  } else {
    using U = std::make_unsigned_t<A>;
    using W = std::conditional_t<sizeof(A) <= 4, unsigned, U>;
    return static_cast<A>(static_cast<U>(static_cast<W>(static_cast<U>(a)) *
                                         static_cast<W>(static_cast<U>(b))));
  }
}

template <int OP, typename A>
__device__ __forceinline__ A fold(A a, A b) {
  if constexpr (OP == kSum || OP == kAvg) {
    return add(a, b);
  } else if constexpr (OP == kProd) {
    return mul(a, b);
  } else if constexpr (OP == kMax) {
    return (a > b || a != a) ? a : b;
  } else if constexpr (OP == kMin) {
    return (a < b || a != a) ? a : b;
  } else if constexpr (OP == kBand) {
    return a & b;
  } else if constexpr (OP == kBor) {
    return a | b;
  } else {
    static_assert(OP == kBxor, "unknown op");
    return a ^ b;
  }
}

template <int OP>
__device__ __forceinline__ bool lfold(bool a, bool b) {
  if constexpr (OP == kLand) return a && b;
  else if constexpr (OP == kLor) return a || b;
  else return a != b;
}

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads) ec_reduce_kernel(
    const ReduceArgs args) {
  using A = typename Acc<T>::type;
  using F = std::conditional_t<sizeof(T) == 8, double, float>;
  constexpr bool kLogical = OP == kLand || OP == kLor || OP == kLxor;
  const F alpha = static_cast<F>(args.alpha);
  const long long step = (long long)gridDim.x * blockDim.x;
  T* dst = static_cast<T*>(args.dst);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < args.count; i += step) {
    A acc = load(static_cast<const T*>(args.src[0]) + i);
    if constexpr (kLogical) {
      if (args.k > 1 || sizeof(T) == 8) {
        bool b = acc != A(0);
#pragma unroll
        for (int j = 1; j < kMaxSrcs; ++j)
          if (j < args.k)
            b = lfold<OP>(b, load(static_cast<const T*>(args.src[j]) + i) !=
                                 A(0));
        acc = b ? A(1) : A(0);
      }
    } else {
#pragma unroll
      for (int j = 1; j < kMaxSrcs; ++j)
        if (j < args.k)
          acc = fold<OP>(acc, load(static_cast<const T*>(args.src[j]) + i));
    }
    if (args.has_alpha) {
      F v = static_cast<F>(acc);
      if constexpr (std::is_same_v<F, double>) v = __dmul_rn(v, alpha);
      else v = __fmul_rn(v, alpha);
      dst[i] = from_float<T, F>(v);
    } else if constexpr (std::is_same_v<A, T>) {
      dst[i] = acc;
    } else {
      dst[i] = from_float<T, float>(acc);
    }
  }
}

// A grid of as many blocks as the card holds resident at once (queried once
// per instance and process: the cards of a host are one model), fewer for
// a short vector.
template <typename T, int OP>
cudaError_t launch(const ReduceArgs& a, cudaStream_t stream) {
  static int max_blocks = 0;
  if (max_blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, ec_reduce_kernel<T, OP>, kThreads, 0);
    if (e != cudaSuccess) return e;
    max_blocks = sms * per_sm;
  }
  long long want = (a.count + kThreads - 1) / kThreads;
  int blocks = (int)(want < max_blocks ? want : max_blocks);
  ec_reduce_kernel<T, OP><<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_op(int op, const ReduceArgs& a, cudaStream_t s) {
  switch (op) {
    case kSum: case kAvg: return launch<T, kSum>(a, s);
    case kProd: return launch<T, kProd>(a, s);
    case kMax: return launch<T, kMax>(a, s);
    case kMin: return launch<T, kMin>(a, s);
    case kLand: return launch<T, kLand>(a, s);
    case kLor: return launch<T, kLor>(a, s);
    case kLxor: return launch<T, kLxor>(a, s);
    default: break;
  }
  if constexpr (std::is_integral_v<T>) {
    switch (op) {
      case kBand: return launch<T, kBand>(a, s);
      case kBor: return launch<T, kBor>(a, s);
      case kBxor: return launch<T, kBxor>(a, s);
      default: break;
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Reduce k sources (host array of k device pointers) of `count` elements
// of type code `dtype` (kernels/ec_reduce.py:DTYPE_CODES) into dst, on
// `stream`. Returns the launch's CUDA error (0 when it was queued).
int ucc_ec_reduce(int dtype, int op, const void* const* srcs, int k,
                  void* dst, long long count, double alpha, int has_alpha,
                  void* stream) {
  if (k < 1 || k > kMaxSrcs || count <= 0) return cudaErrorInvalidValue;
  ReduceArgs a = {};
  for (int j = 0; j < k; ++j) a.src[j] = srcs[j];
  a.dst = dst;
  a.count = count;
  a.k = k;
  a.has_alpha = has_alpha;
  a.alpha = alpha;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return by_op<signed char>(op, a, s);
    case 1: return by_op<unsigned char>(op, a, s);
    case 2: return by_op<short>(op, a, s);
    case 3: return by_op<unsigned short>(op, a, s);
    case 4: return by_op<int>(op, a, s);
    case 5: return by_op<unsigned>(op, a, s);
    case 6: return by_op<long long>(op, a, s);
    case 7: return by_op<unsigned long long>(op, a, s);
    case 8: return by_op<__half>(op, a, s);
    case 9: return by_op<__nv_bfloat16>(op, a, s);
    case 10: return by_op<float>(op, a, s);
    case 11: return by_op<double>(op, a, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* ucc_ec_reduce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
