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
// the card's rate.
//
// Design (only the memory path; every rule above is per element and in
// source order whatever path an element takes). One check on the host
// decides the path of the whole launch. When all k + 1 pointers lie at one
// offset mod 16 (a multiple of the element size), the vector kernel runs:
// the elements before the first 16-byte boundary (the head) and after the
// last whole 16-byte vector (the tail) go one at a time, and every vector
// between them as 16-byte cache-streaming loads and stores; a thread takes
// kDepth vectors at once (u, u + stride, ...: a warp's loads of one source
// are 512 contiguous bytes), issues the loads of kGroup sources for all of
// them, folds those into one accumulator a lane, then the next kGroup
// sources. When the pointers do not share an offset (a strided source at
// an odd element offset, as reduce_strided passes), the scalar kernel runs
// every element one at a time, its loads issued in source order. The two
// are separate kernels so that the scalar one keeps its few registers (and
// its many warps an SM). Each launches a 1-D grid sized from its occupancy
// query and walks it grid-stride. The k loops are unrolled to 9 with a
// guard, so the pointer array stays in parameter space. dst may be one of
// the sources: a thread reads all its elements of every source before it
// writes them.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxSrcs = 9;
constexpr int kThreads = 256;
// 16-byte vectors a thread takes at once, and sources whose loads (for
// all of them) it issues together before it folds them
constexpr int kDepth = 1;
constexpr int kGroup = 3;

struct ReduceArgs {
  const void* src[kMaxSrcs];
  void* dst;
  long long count;
  long long head;  // elements before the first 16-byte boundary
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

// an element of T as its accumulator
template <typename T>
__device__ __forceinline__ typename Acc<T>::type to_acc(T v) {
  return v;
}
template <>
__device__ __forceinline__ float to_acc<__half>(__half v) {
  return __half2float(v);
}
template <>
__device__ __forceinline__ float to_acc<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

// 16 bytes of T: the unit of the vector path
template <typename T>
struct alignas(16) Vec {
  static constexpr int W = 16 / sizeof(T);
  T e[W];
};

template <typename T>
__device__ __forceinline__ Vec<T> load_vec(const T* p) {
  Vec<T> v;
  *reinterpret_cast<uint4*>(&v) = __ldcs(reinterpret_cast<const uint4*>(p));
  return v;
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const Vec<T>& v) {
  __stcs(reinterpret_cast<uint4*>(p), *reinterpret_cast<const uint4*>(&v));
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

// The rules of the header, one source at a time: an element's
// accumulator starts from source 0 (booleanized for a logical op, unless
// k = 1 and T is narrower than 64 bits), folds each later source in
// order, and finishes into T.
template <typename T, int OP>
__device__ __forceinline__ typename Acc<T>::type start(
    const ReduceArgs& args, typename Acc<T>::type v) {
  using A = typename Acc<T>::type;
  if constexpr (OP == kLand || OP == kLor || OP == kLxor) {
    if (args.k > 1 || sizeof(T) == 8) return v != A(0) ? A(1) : A(0);
  }
  return v;
}

template <typename T, int OP>
__device__ __forceinline__ typename Acc<T>::type step(
    typename Acc<T>::type acc, typename Acc<T>::type v) {
  using A = typename Acc<T>::type;
  if constexpr (OP == kLand || OP == kLor || OP == kLxor) {
    return lfold<OP>(acc != A(0), v != A(0)) ? A(1) : A(0);
  } else {
    return fold<OP>(acc, v);
  }
}

template <typename T, typename F>
__device__ __forceinline__ T finish(const ReduceArgs& args, F alpha,
                                    typename Acc<T>::type acc) {
  using A = typename Acc<T>::type;
  if (args.has_alpha) {
    F v = static_cast<F>(acc);
    if constexpr (std::is_same_v<F, double>) v = __dmul_rn(v, alpha);
    else v = __fmul_rn(v, alpha);
    return from_float<T, F>(v);
  } else if constexpr (std::is_same_v<A, T>) {
    return acc;
  } else {
    return from_float<T, float>(acc);
  }
}

// Element i, its sources read one at a time.
template <typename T, int OP, typename F>
__device__ __forceinline__ void reduce_at(const ReduceArgs& args, F alpha,
                                          long long i) {
  using A = typename Acc<T>::type;
  A acc = start<T, OP>(args, to_acc(static_cast<const T*>(args.src[0])[i]));
#pragma unroll
  for (int j = 1; j < kMaxSrcs; ++j)
    if (j < args.k)
      acc = step<T, OP>(acc, to_acc(static_cast<const T*>(args.src[j])[i]));
  static_cast<T*>(args.dst)[i] = finish<T>(args, alpha, acc);
}

// Elements lo .. hi-1, one a thread, grid-stride.
template <typename T, int OP, typename F>
__device__ __forceinline__ void reduce_elements(const ReduceArgs& args,
                                                F alpha, long long lo,
                                                long long hi) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = lo + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < hi; i += stride)
    reduce_at<T, OP>(args, alpha, i);
}

// The scalar path: every element one at a time (pointers at different
// offsets mod 16).
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads) ec_reduce_kernel(
    const ReduceArgs args) {
  using F = std::conditional_t<sizeof(T) == 8, double, float>;
  reduce_elements<T, OP>(args, static_cast<F>(args.alpha), 0, args.count);
}

// The vector path: a thread takes kDepth vectors (u, u + stride, ...),
// issues the loads of kGroup sources for all of them, folds those into one
// accumulator a lane, then the next kGroup sources; then the scalar head
// and tail.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads) ec_reduce_vec_kernel(
    const ReduceArgs args) {
  using A = typename Acc<T>::type;
  using F = std::conditional_t<sizeof(T) == 8, double, float>;
  constexpr int W = Vec<T>::W;
  const F alpha = static_cast<F>(args.alpha);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long head = args.head;
  const long long vecs = (args.count - head) / W;
  const long long tail = head + vecs * W;
  for (long long u = first; u < vecs; u += kDepth * stride) {
    A acc[kDepth][W];
#pragma unroll
    for (int base = 0; base < kMaxSrcs; base += kGroup) {
      if (base < args.k) {
        Vec<T> x[kGroup][kDepth];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          // (an index past the sources when kGroup does not divide 9 is
          // never loaded from)
          const int j = base + i < kMaxSrcs ? base + i : 0;
          const T* src = static_cast<const T*>(args.src[j]) + head;
#pragma unroll
          for (int d = 0; d < kDepth; ++d)
            if (base + i < args.k && u + d * stride < vecs)
              x[i][d] = load_vec(src + (u + d * stride) * W);
        }
#pragma unroll
        for (int i = 0; i < kGroup; ++i)
#pragma unroll
          for (int d = 0; d < kDepth; ++d)
#pragma unroll
            for (int l = 0; l < W; ++l)
              if (base + i < args.k)
                acc[d][l] = base + i == 0
                    ? start<T, OP>(args, to_acc(x[i][d].e[l]))
                    : step<T, OP>(acc[d][l], to_acc(x[i][d].e[l]));
      }
    }
    T* dst = static_cast<T*>(args.dst) + head;
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      if (u + d * stride < vecs) {
        Vec<T> out;
#pragma unroll
        for (int l = 0; l < W; ++l)
          out.e[l] = finish<T>(args, alpha, acc[d][l]);
        store_vec(dst + (u + d * stride) * W, out);
      }
    }
  }
  reduce_elements<T, OP>(args, alpha, 0, head);
  reduce_elements<T, OP>(args, alpha, tail, args.count);
}

// Blocks of `kernel` the card holds resident at once (SMs x blocks an SM),
// queried once per kernel and process: the cards of a host are one model.
cudaError_t resident(const void* kernel, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  *blocks = sms * per_sm;
  return e;
}

// One launch: the vector kernel when all k + 1 pointers lie at one offset
// mod 16 (the one alignment check), else the scalar kernel; a grid of as
// many blocks as the card holds resident, fewer when the walk has fewer
// threads' work.
template <typename T, int OP>
cudaError_t launch(ReduceArgs& a, cudaStream_t stream) {
  static int vec_blocks = 0, scalar_blocks = 0;
  const uintptr_t mis = reinterpret_cast<uintptr_t>(a.dst) & 15;
  bool vec = mis % sizeof(T) == 0;
  for (int j = 0; j < a.k; ++j)
    vec = vec && (reinterpret_cast<uintptr_t>(a.src[j]) & 15) == mis;
  int& cap = vec ? vec_blocks : scalar_blocks;
  const void* kernel = vec ? (const void*)ec_reduce_vec_kernel<T, OP>
                           : (const void*)ec_reduce_kernel<T, OP>;
  if (cap == 0) {
    cudaError_t e = resident(kernel, &cap);
    if (e != cudaSuccess) return e;
  }
  long long items = a.count;  // threads the walk can use at once
  if (vec) {
    const long long head = (long long)((16 - mis) & 15) / sizeof(T);
    a.head = head < a.count ? head : a.count;
    const long long vecs = (a.count - a.head) / Vec<T>::W;
    items = (vecs + kDepth - 1) / kDepth;
    if (items < 1) items = 1;  // the head and the tail
  }
  long long want = (items + kThreads - 1) / kThreads;
  int blocks = (int)(want < cap ? want : cap);
  void* params[] = {&a};
  cudaError_t e = cudaLaunchKernel(kernel, dim3(blocks), dim3(kThreads),
                                   params, 0, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_op(int op, ReduceArgs& a, cudaStream_t s) {
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
