// Device building blocks shared by the kernels of this directory
// (gen_device.cu, and through direct_fold.cuh ring_allreduce.cu,
// reduce_scatter.cu, gen_fold.cu, alltoall.cu, bcast.cu and allgather.cu):
// element arithmetic in the rounding of PyTorch's own kernels, the
// comm-slot loads and stores, a bounded acquire spin on a release-stored
// counter with a sticky error word, and the all-rank barrier built from
// the same release stores and bounded spins.
//
// Everything here has internal linkage: each source that includes it is
// built into its own library.

#pragma once

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// ReductionOp values of ucc_tpu_torch.constants
constexpr int OP_SUM = 0;
constexpr int OP_PROD = 1;
constexpr int OP_MAX = 2;
constexpr int OP_MIN = 3;
constexpr int OP_AVG = 12;

// dtype codes of ucc_tpu_torch/kernels/ring_common.py (unsigned 16-, 32-
// and 64-bit integers have none: torch has no add, max or min for them on
// the CPU, where the plain versions run)
constexpr int DT_F32 = 0;
constexpr int DT_F16 = 1;
constexpr int DT_BF16 = 2;
constexpr int DT_I32 = 3;
constexpr int DT_I64 = 4;
constexpr int DT_I8 = 5;
constexpr int DT_U8 = 6;
constexpr int DT_I16 = 7;
constexpr int DT_F64 = 8;

// error word values
constexpr int ERR_SPIN_TIMEOUT = 1;

// about 2^26 polls with a 128 ns back-off: several seconds
constexpr long long SPIN_LIMIT = 1ll << 26;

// ---------------------------------------------------------------------
// element arithmetic, in the rounding of PyTorch's own kernels
template <typename T> struct Elem;

template <> struct Elem<float> {
  using Bits = unsigned int;
  static __device__ float add(float a, float b) { return a + b; }
  static __device__ float mul(float a, float b) { return a * b; }
  static __device__ bool is_nan(float a) { return a != a; }
  static __device__ float tof(float a) { return a; }
  static __device__ float avg(float a, int n) { return a / (float)n; }
};

template <> struct Elem<__half> {
  using Bits = unsigned short;
  static __device__ __half add(__half a, __half b) {
    return __float2half_rn(__half2float(a) + __half2float(b));
  }
  static __device__ __half mul(__half a, __half b) {
    return __float2half_rn(__half2float(a) * __half2float(b));
  }
  static __device__ bool is_nan(__half a) {
    float f = __half2float(a);
    return f != f;
  }
  static __device__ float tof(__half a) { return __half2float(a); }
  static __device__ __half avg(__half a, int n) {
    return __float2half_rn(__half2float(a) / (float)n);
  }
};

template <> struct Elem<__nv_bfloat16> {
  using Bits = unsigned short;
  static __device__ __nv_bfloat16 add(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
  }
  static __device__ __nv_bfloat16 mul(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __float2bfloat16_rn(__bfloat162float(a) * __bfloat162float(b));
  }
  static __device__ bool is_nan(__nv_bfloat16 a) {
    float f = __bfloat162float(a);
    return f != f;
  }
  static __device__ float tof(__nv_bfloat16 a) { return __bfloat162float(a); }
  static __device__ __nv_bfloat16 avg(__nv_bfloat16 a, int n) {
    return __float2bfloat16_rn(__bfloat162float(a) / (float)n);
  }
};

// integers wrap on overflow, as torch and jnp do: the arithmetic runs in
// 64-bit unsigned (no signed overflow, no promotion to int) and keeps the
// low bits; AVG divides in float32 and truncates, as (x / n).to(int) does
template <typename T, typename U>
struct IntElem {
  using Bits = U;
  using W = unsigned long long;
  static __device__ T add(T a, T b) { return (T)(U)((W)a + (W)b); }
  static __device__ T mul(T a, T b) { return (T)(U)((W)a * (W)b); }
  static __device__ bool is_nan(T) { return false; }
  static __device__ float tof(T a) { return (float)a; }
  static __device__ T avg(T a, int n) { return (T)((float)a / (float)n); }
};

template <> struct Elem<signed char> : IntElem<signed char, unsigned char> {};
template <> struct Elem<unsigned char>
    : IntElem<unsigned char, unsigned char> {};
template <> struct Elem<short> : IntElem<short, unsigned short> {};
template <> struct Elem<int> : IntElem<int, unsigned int> {};
template <> struct Elem<long long>
    : IntElem<long long, unsigned long long> {};

// float64 keeps its own precision throughout (torch divides it in float64)
template <> struct Elem<double> {
  using Bits = unsigned long long;
  static __device__ double add(double a, double b) { return a + b; }
  static __device__ double mul(double a, double b) { return a * b; }
  static __device__ bool is_nan(double a) { return a != a; }
  static __device__ float tof(double a) { return (float)a; }
  static __device__ double avg(double a, int n) { return a / (double)n; }
};

// A float or double value in T, rounded to nearest (16-bit floats through
// float: the values given are exact there).
template <typename T> __device__ T from_float(float v) { return (T)v; }
template <> __device__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}
template <> __device__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T> __device__ T from_double(double v) { return (T)v; }
template <> __device__ __half from_double<__half>(double v) {
  return __float2half_rn((float)v);
}
template <> __device__ __nv_bfloat16 from_double<__nv_bfloat16>(double v) {
  return __float2bfloat16_rn((float)v);
}

// 16-bit floats compare as float (exactly); every other type in its own.
template <typename T> __device__ bool gt(T a, T b) { return a > b; }
template <> __device__ bool gt<__half>(__half a, __half b) {
  return Elem<__half>::tof(a) > Elem<__half>::tof(b);
}
template <> __device__ bool gt<__nv_bfloat16>(__nv_bfloat16 a,
                                              __nv_bfloat16 b) {
  return Elem<__nv_bfloat16>::tof(a) > Elem<__nv_bfloat16>::tof(b);
}

// acc(local, incoming); MAX and MIN propagate NaN like torch.maximum /
// jnp.maximum (fmaxf would drop it)
template <typename T>
__device__ T accumulate(int op, T a, T b) {
  switch (op) {
    case OP_PROD:
      return Elem<T>::mul(a, b);
    case OP_MAX:
      if (Elem<T>::is_nan(a)) return a;
      if (Elem<T>::is_nan(b)) return b;
      return gt(b, a) ? b : a;
    case OP_MIN:
      if (Elem<T>::is_nan(a)) return a;
      if (Elem<T>::is_nan(b)) return b;
      return gt(a, b) ? b : a;
    default:  // SUM, AVG
      return Elem<T>::add(a, b);
  }
}

// comm slots bypass L1 (written by another SM)
template <typename T>
__device__ void store_slot(T* p, T v) {
  using B = typename Elem<T>::Bits;
  __stcg(reinterpret_cast<B*>(p), *reinterpret_cast<B*>(&v));
}

template <typename T>
__device__ T load_slot(const T* p) {
  using B = typename Elem<T>::Bits;
  B b = __ldcg(reinterpret_cast<const B*>(p));
  return *reinterpret_cast<T*>(&b);
}

__device__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// The calling thread spins until *p >= target, bounded: when the spin runs
// out it sets the error word, and when another CTA has set it, it stops
// early; either way it raises *abort_flag.
__device__ void spin_geq(const unsigned* p, unsigned target, int* err,
                         volatile int* abort_flag) {
  long long it = 0;
  while (load_acquire(p) < target) {
    ++it;
    if ((it & 255) == 0 && *(volatile int*)err != 0) {
      *abort_flag = 1;
      return;
    }
    if (it > SPIN_LIMIT) {
      atomicCAS(err, 0, ERR_SPIN_TIMEOUT);
      *abort_flag = 1;
      return;
    }
    if (it > 32) __nanosleep(128);
  }
}

// All-rank barrier of one lane, the counterpart of ring_dma.py's
// _all_rank_barrier: CTA (r, c) of an n-rank grid posts `epoch` into the
// word it owns at every other rank, then waits until every other rank has
// posted `epoch` into its own words. The words of lane c are
// words[(receiver * lanes + c) * n + sender], one per (sender, receiver)
// pair, each written by its sender alone (a release store after the CTA's
// earlier stores) and read by its receiver alone (an acquire spin, bounded
// by spin_geq). Epochs grow within a launch; the launch zeroes the words.
// Every thread returns false when a spin ran out.
//   No kernel calls it, and teams that span processes do not either: their
// rounds are ordered by interprocess CUDA events on the streams and by the
// team's sync area on the host (tl/device_sync.py). A barrier spinning
// inside a kernel would wait on another process's kernel: processes that
// share the card without MPS are time-sliced, so the spin waits out whole
// slices; under MPS two full-occupancy grids cannot be resident at once, so
// the spinning grid starves the other and ends on SPIN_LIMIT; and either
// way a kernel would depend on another process's host launching in time.
// It stays for the cooperative layer kernel's kind of launch (one grid over
// all ranks, every CTA resident), where it holds.
__device__ bool all_rank_barrier(unsigned* words, int n, unsigned epoch,
                                 int* err, volatile int* abort_flag) {
  const int r = blockIdx.y;
  const size_t lanes = gridDim.x;
  const size_t c = blockIdx.x;
  __syncthreads();  // every thread's stores before the barrier are issued
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    if (p == r) continue;
    __threadfence();
    store_release(words + ((size_t)p * lanes + c) * n + r, epoch);
  }
  if (threadIdx.x == 0) {
    const unsigned* mine = words + ((size_t)r * lanes + c) * n;
    for (int q = 0; q < n && *abort_flag == 0; ++q)
      if (q != r) spin_geq(mine + q, epoch, err, abort_flag);
    __threadfence();
  }
  __syncthreads();
  return *abort_flag == 0;
}

}  // namespace
