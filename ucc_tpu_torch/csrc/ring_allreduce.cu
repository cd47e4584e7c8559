// Ring allreduce over the n ranks of one GPU, as one kernel launch.
//
// Replaces the Pallas ring kernels of the JAX package:
//   ring_allreduce_pass    <- ucc_tpu/tl/ring_dma.py:_ring_kernel (allreduce
//                             mode), the one-pass ring built by
//                             build_ring_program;
//   ring_allreduce_chunked <- ucc_tpu/tl/ring_dma.py:_hbm_allreduce_kernel,
//                             the same ring once per chunk.
// Both entry points share ring_body below; the element arithmetic and the
// flag protocol are those of ring_common.cuh.
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

#include "ring_common.cuh"

namespace {

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
    case DT_I8: return kernel_for<signed char>(chunked);
    case DT_U8: return kernel_for<unsigned char>(chunked);
    case DT_I16: return kernel_for<short>(chunked);
    case DT_F64: return kernel_for<double>(chunked);
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
// the launch (0 on success). `root` is part of the common interface and
// unused here.
int ucc_ring_allreduce(int chunked, int dtype, void* const* ptrs,
                       void* comm, unsigned* flags, int* err,
                       long long count, long long blk, int n_chunks, int n,
                       int op, int root, int lanes, int threads,
                       cudaStream_t stream) {
  (void)root;
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
