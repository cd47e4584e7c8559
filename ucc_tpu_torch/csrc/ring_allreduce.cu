// Ring allreduce over the n ranks of one GPU, as one kernel launch.
//
// Replaces the Pallas ring kernels of the JAX package:
//   ring_allreduce_pass    <- ucc_tpu/tl/ring_dma.py:_ring_kernel (allreduce
//                             mode), the one-pass ring built by
//                             build_ring_program;
//   ring_allreduce_chunked <- ucc_tpu/tl/ring_dma.py:_hbm_allreduce_kernel,
//                             the same ring once per chunk.
// Both entry points share ring_body below.
//
// What it computes. Rank r holds count elements, split (after zero
// padding) into chunks of n blocks of blk elements; the pass entry is the
// one-chunk case with blk = ceil(count / n). Per chunk, global step t runs
// n-1 reduce-scatter steps (send block r-s, fold the block received from
// the left into block r-s-1: work[recv] = acc(work[recv], incoming)) and
// then n-1 allgather steps (send block r+1-s, overwrite block r-s). That
// is the step schedule and accumulation order of _ring_reduce_steps, so
// float results are bitwise those of the plain PyTorch version in
// ucc_tpu_torch/kernels/ring_allreduce.py. f16 and bf16 round to their own
// type after every operation; AVG is SUM divided by n at the end, in the
// same launch.
//
// Design. CTA (r, c) plays rank r on lane slice c of every block, and talks
// only to CTAs (r-1, c) and (r+1, c): no synchronisation spans the grid.
// A remote copy is a store into the right neighbour's receive slot in
// global memory, then a release store of a step counter; the receiver
// spins on it with an acquire load. Slots alternate with the step's
// parity, and the consumer ack of the TPU kernel is kept: before writing
// slot t&1 a sender waits until its right neighbour has acknowledged
// consuming step t-2 (the 2-slot parity rule with its throttle). The
// launch is cooperative, so every CTA is resident and the spins cannot
// deadlock on an unscheduled peer. Every spin is bounded; on timeout the
// kernel sets the error word, every CTA leaves, and the host wrapper
// raises.
//
// What bounds it: bytes. The least traffic is reading n*S and writing n*S
// bytes for S bytes per rank (each input read once, each output written
// once): 2*n*S at 3.35 TB/s on an H100 SXM. The ring schedule itself moves
// more: the src->dst copy (2*S per rank), and per step a block read from
// work, written to a slot, read back and folded into work (5 block
// accesses per reduce step, 4 per allgather step), about 11*S per rank in
// all for n = 8. The slots of a chunk are small enough to stay in the 50 MB
// L2, so most of the step traffic need not reach HBM.
//
// This first version is plain: scalar loads, one handshake per step per
// CTA. Making it fast comes in later PRs: staging blocks through shared
// memory with cp.async or TMA, vector loads, fewer handshakes, and for
// n <= 8 thread-block clusters with distributed shared memory in place of
// the global-memory slots.

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

// dtype codes of ucc_tpu_torch/kernels/ring_allreduce.py
constexpr int DT_F32 = 0;
constexpr int DT_F16 = 1;
constexpr int DT_BF16 = 2;
constexpr int DT_I32 = 3;
constexpr int DT_I64 = 4;

// error word values
constexpr int ERR_SPIN_TIMEOUT = 1;

// about 2^26 polls with a 128 ns back-off: several seconds
constexpr long long SPIN_LIMIT = 1ll << 26;

struct RingArgs {
  void* const* ptrs;   // device array: n src pointers, then n dst pointers
  void* comm;          // n ranks x 2 slots x blk elements
  unsigned* flags;     // n ranks x C lanes x {recv counter, ack counter}
  int* err;            // sticky error word
  long long count;     // elements per rank
  long long blk;       // elements per block
  int n_chunks;
  int n;
  int op;
};

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

// integers wrap on overflow (unsigned arithmetic), as torch and jnp do;
// AVG divides in float32 and truncates, as (x / n).to(int) does
template <> struct Elem<int> {
  using Bits = unsigned int;
  static __device__ int add(int a, int b) {
    return (int)((unsigned int)a + (unsigned int)b);
  }
  static __device__ int mul(int a, int b) {
    return (int)((unsigned int)a * (unsigned int)b);
  }
  static __device__ bool is_nan(int) { return false; }
  static __device__ float tof(int a) { return (float)a; }
  static __device__ int avg(int a, int n) {
    return (int)((float)a / (float)n);
  }
};

template <> struct Elem<long long> {
  using Bits = unsigned long long;
  static __device__ long long add(long long a, long long b) {
    return (long long)((unsigned long long)a + (unsigned long long)b);
  }
  static __device__ long long mul(long long a, long long b) {
    return (long long)((unsigned long long)a * (unsigned long long)b);
  }
  static __device__ bool is_nan(long long) { return false; }
  static __device__ float tof(long long a) { return (float)a; }
  static __device__ long long avg(long long a, int n) {
    return (long long)((float)a / (float)n);
  }
};

// Integers compare exactly; floats compare as float (exact for f16/bf16).
template <typename T> __device__ bool gt(T a, T b) {
  return Elem<T>::tof(a) > Elem<T>::tof(b);
}
template <> __device__ bool gt<int>(int a, int b) { return a > b; }
template <> __device__ bool gt<long long>(long long a, long long b) {
  return a > b;
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

// Thread 0 spins until *p >= target; every thread returns false when the
// spin ran out (here or in another CTA).
__device__ bool wait_geq(const unsigned* p, unsigned target, int* err,
                         volatile int* abort_flag) {
  if (threadIdx.x == 0) {
    long long it = 0;
    while (load_acquire(p) < target) {
      ++it;
      if ((it & 255) == 0 && *(volatile int*)err != 0) {
        *abort_flag = 1;
        break;
      }
      if (it > SPIN_LIMIT) {
        atomicCAS(err, 0, ERR_SPIN_TIMEOUT);
        *abort_flag = 1;
        break;
      }
      if (it > 32) __nanosleep(128);
    }
    __threadfence();
  }
  __syncthreads();
  return *abort_flag == 0;
}

__device__ void publish(unsigned* p, unsigned v) {
  __syncthreads();  // every thread's stores of this step are issued
  if (threadIdx.x == 0) {
    __threadfence();
    store_release(p, v);
  }
}

__device__ int mod(int a, int n) { return ((a % n) + n) % n; }

template <typename T>
__device__ void ring_body(const RingArgs& a) {
  __shared__ int abort_flag;
  const int n = a.n;
  const int r = blockIdx.y;
  const int c = blockIdx.x;
  const int lanes = gridDim.x;
  const int right = (r + 1) % n;
  const long long blk = a.blk;
  const long long csize = blk * n;
  const long long lane = (blk + lanes - 1) / lanes;
  const long long lo = min(blk, (long long)c * lane);
  const long long hi = min(blk, lo + lane);
  const T* src = static_cast<const T*>(a.ptrs[r]);
  T* work = static_cast<T*>(a.ptrs[n + r]);
  T* my_slots = static_cast<T*>(a.comm) + (size_t)r * 2 * blk;
  T* right_slots = static_cast<T*>(a.comm) + (size_t)right * 2 * blk;
  unsigned* my_recv = a.flags + ((size_t)r * lanes + c) * 2;
  unsigned* my_ack = my_recv + 1;
  unsigned* right_recv = a.flags + ((size_t)right * lanes + c) * 2;
  const unsigned* right_ack = right_recv + 1;

  if (threadIdx.x == 0) abort_flag = 0;
  if (src != work) {
    for (int k = 0; k < a.n_chunks; ++k)
      for (int b = 0; b < n; ++b)
        for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
          long long g = k * csize + b * blk + i;
          if (g < a.count) work[g] = src[g];
        }
  }
  __syncthreads();

  unsigned t = 0;
  for (int k = 0; k < a.n_chunks; ++k) {
    T* w = work + k * csize;
    const long long limit = a.count - k * csize;  // real elements in chunk
    for (int s = 0; s < 2 * (n - 1); ++s, ++t) {
      const bool reduce = s < n - 1;
      const int s2 = reduce ? s : s - (n - 1);
      const int send_i = reduce ? mod(r - s2, n) : mod(r + 1 - s2, n);
      const int recv_i = reduce ? mod(r - s2 - 1, n) : mod(r - s2, n);
      // slot t&1 of the right neighbour is free once it consumed step t-2
      if (t >= 2 && !wait_geq(right_ack, t - 1, a.err, &abort_flag)) return;
      T* out_slot = right_slots + (t & 1) * blk;
      for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
        long long g = (long long)send_i * blk + i;
        if (g < limit) store_slot(out_slot + i, w[g]);
      }
      publish(right_recv, t + 1);
      if (!wait_geq(my_recv, t + 1, a.err, &abort_flag)) return;
      const T* in_slot = my_slots + (t & 1) * blk;
      for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
        long long g = (long long)recv_i * blk + i;
        if (g < limit) {
          T in = load_slot(in_slot + i);
          w[g] = reduce ? accumulate(a.op, w[g], in) : in;
        }
      }
      publish(my_ack, t + 1);
    }
  }

  if (a.op == OP_AVG) {
    for (int k = 0; k < a.n_chunks; ++k)
      for (int b = 0; b < n; ++b)
        for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
          long long g = k * csize + b * blk + i;
          if (g < a.count) work[g] = Elem<T>::avg(work[g], n);
        }
  }
}

template <typename T>
__global__ void ring_allreduce_pass_kernel(RingArgs a) {
  ring_body<T>(a);
}

template <typename T>
__global__ void ring_allreduce_chunked_kernel(RingArgs a) {
  ring_body<T>(a);
}

template <typename T>
const void* kernel_for(int chunked) {
  return chunked ? (const void*)ring_allreduce_chunked_kernel<T>
                 : (const void*)ring_allreduce_pass_kernel<T>;
}

const void* select_kernel(int chunked, int dtype) {
  switch (dtype) {
    case DT_F32: return kernel_for<float>(chunked);
    case DT_F16: return kernel_for<__half>(chunked);
    case DT_BF16: return kernel_for<__nv_bfloat16>(chunked);
    case DT_I32: return kernel_for<int>(chunked);
    case DT_I64: return kernel_for<long long>(chunked);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Most CTAs of `threads` threads that can be resident at once for this
// kernel (SMs x blocks per SM): the bound on n x lanes.
int ucc_ring_allreduce_max_ctas(int chunked, int dtype, int threads,
                                int* out) {
  const void* kern = select_kernel(chunked, dtype);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      0);
  *out = sms * per_sm;
  return (int)e;
}

// Launch one ring allreduce on `stream`; returns cudaGetLastError() after
// the launch (0 on success).
int ucc_ring_allreduce(int chunked, int dtype, void* const* ptrs,
                       void* comm, unsigned* flags, int* err,
                       long long count, long long blk, int n_chunks, int n,
                       int op, int lanes, int threads, cudaStream_t stream) {
  const void* kern = select_kernel(chunked, dtype);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  RingArgs a{ptrs, comm, flags, err, count, blk, n_chunks, n, op};
  void* params[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(kern, dim3(lanes, n),
                                              dim3(threads), params, 0,
                                              stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* ucc_ring_allreduce_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
