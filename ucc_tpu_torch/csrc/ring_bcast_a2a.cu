// Ring-pipelined bcast over the n ranks of one GPU, as one kernel launch.
//
// Replaces the Pallas kernels of the JAX package:
//   ring_bcast_pass        <- ucc_tpu/tl/ring_dma.py:_bcast_kernel
//                             (build_bcast_program);
//   ring_bcast_chunked     <- ucc_tpu/tl/ring_dma.py:_hbm_bcast_kernel
//                             (build_hbm_bcast_program).
// The two entry points share a body; they differ in geometry only. The
// flag protocol is ring_common.cuh's. A bcast only copies, so every result
// is bitwise the root's src, whatever the sub-block size, as in the plain
// PyTorch version of ucc_tpu_torch/kernels/ring_bcast_a2a.py. (That module's
// alltoall launches alltoall.cu's kernel.)
//
// The root's count elements go to every rank, in nsub sub-blocks of blk
// elements (the last one ragged), around the ring from the root: the rank
// at ring distance d from the root receives sub-block s from its left
// neighbour and forwards it to its right one, so sub-block s reaches it at
// step s + d - 1 of the reference's nsub + n - 2 steps. Nothing stages
// through slots: every non-root dst sub-block is written exactly once (as
// in ring_rs_ag.cu's allgather), so a rank stores a sub-block straight
// into its right neighbour's dst and publishes a step counter (release
// store); the neighbour forwards from its own dst once it has acquired
// that counter. The flag is the only handshake: a dst is never rewritten
// in a launch, so no consumer ack is needed. The schedule is not the
// reference's symmetric one: the wrap-around into the root carried ignored
// data on the TPU and would clobber the root's data here, so the rank at
// distance n-1 forwards nothing. The root copies src to its dst only when
// they differ (UCC's bcast passes src alone, and then the root's buffer is
// its result). The TPU's even-step padding of the chunked kernel (its grid
// pairs steps for static slot parity) has no counterpart: the sub-block
// loop runs inside the CTA.
//
// What bounds it: bytes. A bcast must read the root's S bytes once and
// write (n-1) copies, n*S in all; the ring reads every forwarded sub-block
// back ((n-2)*S more), from L2 where the sub-block just landed: with blk
// = CHUNK_ELEMS/2 (2 MiB f32) a step of 8 ranks touches 16 MiB, inside the
// 50 MB L2.
//
// This first version is plain: scalar loads and stores, one handshake per
// sub-block per CTA.

#include "ring_common.cuh"

namespace {

// kernel ids of ucc_tpu_torch/kernels/ring_bcast_a2a.py
constexpr int K_BCAST_PASS = 0;
constexpr int K_BCAST_CHUNKED = 1;

struct BcastArgs {
  void* const* ptrs;   // device array: n src pointers, then n dst pointers
  unsigned* flags;     // n ranks x C lanes x {recv counter}
  int* err;            // sticky error word
  long long count;     // elements per rank
  long long sub;       // sub-block elements
  int n_sub;           // sub-blocks
  int n;
  int root;            // the root rank
};

// Lane slice [lo, hi) of a sub-block that this CTA handles.
__device__ void lane_slice(long long span, long long* lo, long long* hi) {
  const long long lane = (span + gridDim.x - 1) / gridDim.x;
  *lo = min(span, (long long)blockIdx.x * lane);
  *hi = min(span, *lo + lane);
}

template <typename T>
__device__ void bcast_body(const BcastArgs& a) {
  __shared__ int abort_flag;
  const int n = a.n;
  const int r = blockIdx.y;
  const int c = blockIdx.x;
  const int right = (r + 1) % n;
  const int dist = mod(r - a.root, n);
  long long lo, lane_hi;
  lane_slice(a.sub, &lo, &lane_hi);
  const T* src = static_cast<const T*>(a.ptrs[r]);
  T* dst = static_cast<T*>(a.ptrs[n + r]);
  T* right_dst = static_cast<T*>(a.ptrs[n + right]);
  unsigned* my_recv = a.flags + (size_t)r * gridDim.x + c;
  unsigned* right_recv = a.flags + (size_t)right * gridDim.x + c;
  // the rank before the root forwards nothing
  const bool forward = dist < n - 1;

  if (threadIdx.x == 0) abort_flag = 0;
  __syncthreads();
  for (int s = 0; s < a.n_sub; ++s) {
    const long long base = (long long)s * a.sub;
    const long long hi = min(lane_hi, a.count - base);  // real elements only
    if (dist == 0) {
      for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
        T v = src[base + i];
        if (dst != src) dst[base + i] = v;
        if (forward) store_slot(right_dst + base + i, v);
      }
    } else {
      // sub-block s has landed in my dst once the left neighbour says so
      if (!wait_geq(my_recv, s + 1, a.err, &abort_flag)) return;
      if (forward)
        for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x)
          store_slot(right_dst + base + i, load_slot(dst + base + i));
    }
    if (forward) publish(right_recv, s + 1);
  }
}

template <typename T>
__global__ void ring_bcast_pass_kernel(BcastArgs a) {
  bcast_body<T>(a);
}

template <typename T>
__global__ void ring_bcast_chunked_kernel(BcastArgs a) {
  bcast_body<T>(a);
}

template <typename T>
const void* kernel_for(int kernel) {
  switch (kernel) {
    case K_BCAST_PASS: return (const void*)ring_bcast_pass_kernel<T>;
    case K_BCAST_CHUNKED: return (const void*)ring_bcast_chunked_kernel<T>;
    default: return nullptr;
  }
}

const void* select_kernel(int kernel, int dtype) {
  switch (dtype) {
    case DT_F32: return kernel_for<float>(kernel);
    case DT_F16: return kernel_for<__half>(kernel);
    case DT_BF16: return kernel_for<__nv_bfloat16>(kernel);
    case DT_I32: return kernel_for<int>(kernel);
    case DT_I64: return kernel_for<long long>(kernel);
    case DT_I8: return kernel_for<signed char>(kernel);
    case DT_U8: return kernel_for<unsigned char>(kernel);
    case DT_I16: return kernel_for<short>(kernel);
    case DT_F64: return kernel_for<double>(kernel);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Most CTAs of `threads` threads that can be resident at once for this
// kernel (SMs x blocks per SM): the bound on n x lanes.
int ucc_ring_bcast_a2a_max_ctas(int kernel, int dtype, int threads,
                                int* out) {
  const void* kern = select_kernel(kernel, dtype);
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

// Launch one bcast on `stream`; returns cudaGetLastError() after the
// launch (0 on success). A bcast uses no comm slots or op: `comm` and `op`
// are part of the common interface.
int ucc_ring_bcast_a2a(int kernel, int dtype, void* const* ptrs, void* comm,
                       unsigned* flags, int* err, long long count,
                       long long sub, int n_sub, int n, int op, int root,
                       int lanes, int threads, cudaStream_t stream) {
  (void)comm;
  (void)op;
  const void* kern = select_kernel(kernel, dtype);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  BcastArgs a{ptrs, flags, err, count, sub, n_sub, n, root};
  void* params[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(kern, dim3(lanes, n),
                                              dim3(threads), params, 0,
                                              stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* ucc_ring_bcast_a2a_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
