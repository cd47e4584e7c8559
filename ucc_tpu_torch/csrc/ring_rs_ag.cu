// Ring reduce_scatter and ring allgather over the n ranks of one GPU, each
// as one kernel launch.
//
// Replaces the Pallas ring kernels of the JAX package:
//   ring_reduce_scatter_pass    <- ucc_tpu/tl/ring_dma.py:_ring_kernel in
//                                  reduce_scatter mode (build_ring_program);
//   ring_reduce_scatter_chunked <- ucc_tpu/tl/ring_dma.py:
//                                  _hbm_reduce_scatter_kernel;
//   ring_allgather_pass         <- ucc_tpu/tl/ring_dma.py:_ring_kernel in
//                                  allgather mode;
//   ring_allgather_chunked      <- ucc_tpu/tl/ring_dma.py:
//                                  _hbm_allgather_kernel.
// A pass entry is the one-chunk case of its chunked twin (cblk = blk); the
// two share a body. The element arithmetic and the CTA-pair flag protocol
// are those of ring_common.cuh.
//
// What it computes. Every rank's per-rank block holds blk elements; a
// chunk is the same cblk-element sub-range of every block, and chunks run
// one after another, each a ring of its own.
// - reduce_scatter: rank r's src is n blocks, its dst is block r of the
//   reduction. With the ring shift c = 1 of _ring_reduce_steps, step m
//   (m = 0..n-2) folds the block received from the left into block
//   r-m-2 as acc(local, incoming); after n-1 steps rank r holds block r,
//   accumulated as acc(x_r, acc(x_{r-1}, ... acc(x_{r+2}, x_{r+1}))). That
//   order depends on the block index alone, so every chunk size gives the
//   same bits, and the bits of the plain PyTorch version in
//   ucc_tpu_torch/kernels/ring_rs_ag.py. f16 and bf16 round after every
//   operation; AVG is SUM divided by n in the last step.
// - allgather: rank r's dst is the n blocks in rank order; block b leaves
//   rank b and is forwarded n-1 times around the ring. Copies only, so the
//   result is bitwise torch.cat.
//
// Design. CTA (r, c) plays rank r on lane slice c of every chunk and talks
// only to CTAs (r-1, c) and (r+1, c), with the release/acquire step
// counters, bounded spins and sticky error word of ring_allreduce.cu; the
// launch is cooperative, so every CTA is resident.
// - reduce_scatter keeps no whole-vector work buffer (the Pallas kernel
//   folds into a VMEM copy of its input): the block a rank sends at step
//   m+1 is exactly the block it folded at step m, so a step reads the
//   incoming slot and its own src block, and stores the fold straight into
//   the right neighbour's next slot (the last fold goes to dst). The slots
//   alternate with the message's parity, and the consumer ack of the TPU
//   kernel is kept: before writing slot t&1 a sender waits until its right
//   neighbour has consumed message t-2. Block r of src is read only in the
//   last step, just before dst is written, so in place (src = the whole
//   dst vector, dst = its block r) is safe.
// - allgather stores straight into the right neighbour's dst block: every
//   dst block is written exactly once, so it needs neither slots nor their
//   2-slot parity and ack, only the step counter that says a block has
//   arrived and may be forwarded. In place (src = block r of dst) skips
//   the copy of the own block.
//
// What bounds it: bytes. The least traffic is each input read once and each
// output written once: reduce_scatter n*(n*S) read and n*S written for S
// bytes of output per rank; allgather n*S read and n*(n*S) written. On top
// of that the reduce_scatter ring writes and reads every message through a
// slot (2*(n-1)*S per rank) and the allgather ring reads each forwarded
// block back ((n-2)*S per rank). With chunks of CHUNK_ELEMS / n elements per
// block, the blocks of one chunk step over all ranks stay in the 50 MB L2,
// so that extra traffic need not reach HBM.
//
// This first version is plain: scalar loads and stores, one handshake per
// step per CTA, as ring_allreduce.cu.

#include "ring_common.cuh"

namespace {

// kernel ids of ucc_tpu_torch/kernels/ring_rs_ag.py
constexpr int K_RS_PASS = 0;
constexpr int K_RS_CHUNKED = 1;
constexpr int K_AG_PASS = 2;
constexpr int K_AG_CHUNKED = 3;

struct RsAgArgs {
  void* const* ptrs;   // device array: n src pointers, then n dst pointers
  void* comm;          // reduce_scatter: n ranks x 2 slots x cblk elements
  unsigned* flags;     // n ranks x C lanes x {recv counter, ack counter}
  int* err;            // sticky error word
  long long blk;       // elements of one rank-block
  long long cblk;      // elements of a block in one chunk
  int n_chunks;        // ceil(blk / cblk)
  int n;
  int op;
};

// Lane slice [lo, hi) of a chunk's block that this CTA handles.
__device__ void lane_slice(long long cblk, long long* lo, long long* hi) {
  const long long lane = (cblk + gridDim.x - 1) / gridDim.x;
  *lo = min(cblk, (long long)blockIdx.x * lane);
  *hi = min(cblk, *lo + lane);
}

template <typename T>
__device__ T finish(int op, T v, int n) {
  return op == OP_AVG ? Elem<T>::avg(v, n) : v;
}

template <typename T>
__device__ void reduce_scatter_body(const RsAgArgs& a) {
  __shared__ int abort_flag;
  const int n = a.n;
  const int r = blockIdx.y;
  const int c = blockIdx.x;
  const int right = (r + 1) % n;
  const long long blk = a.blk;
  const long long cblk = a.cblk;
  long long lo, lane_hi;
  lane_slice(cblk, &lo, &lane_hi);
  const T* src = static_cast<const T*>(a.ptrs[r]);
  T* dst = static_cast<T*>(a.ptrs[n + r]);
  T* my_slots = static_cast<T*>(a.comm) + (size_t)r * 2 * cblk;
  T* right_slots = static_cast<T*>(a.comm) + (size_t)right * 2 * cblk;
  unsigned* my_recv = a.flags + ((size_t)r * gridDim.x + c) * 2;
  unsigned* my_ack = my_recv + 1;
  unsigned* right_recv = a.flags + ((size_t)right * gridDim.x + c) * 2;
  const unsigned* right_ack = right_recv + 1;

  if (threadIdx.x == 0) abort_flag = 0;
  __syncthreads();
  for (int k = 0; k < a.n_chunks; ++k) {
    const long long base = (long long)k * cblk;
    const long long hi = min(lane_hi, blk - base);  // real elements only
    if (n == 1) {
      for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x)
        dst[base + i] = finish(a.op, src[base + i], n);
      continue;
    }
    // Messages are numbered over the whole launch, n-1 per chunk; message
    // u goes into the right neighbour's slot u&1. The first of a chunk is
    // my block r-1 as it is.
    const unsigned u = (unsigned)k * (n - 1);
    if (u >= 2 && !wait_geq(right_ack, u - 1, a.err, &abort_flag)) return;
    const T* first = src + (long long)mod(r - 1, n) * blk + base;
    T* out = right_slots + (u & 1) * cblk;
    for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x)
      store_slot(out + i, first[i]);
    publish(right_recv, u + 1);
    for (int m = 0; m < n - 1; ++m) {
      const unsigned t = u + m;  // the message folded now
      const bool last = m == n - 2;
      if (!wait_geq(my_recv, t + 1, a.err, &abort_flag)) return;
      // the fold is message t+1: the right neighbour's slot (t+1)&1 is
      // free once it consumed message t-1
      if (!last && t >= 1 && !wait_geq(right_ack, t, a.err, &abort_flag))
        return;
      const T* in = my_slots + (t & 1) * cblk;
      const T* mine = src + (long long)mod(r - m - 2, n) * blk + base;
      T* next = right_slots + ((t + 1) & 1) * cblk;
      for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
        T v = accumulate(a.op, mine[i], load_slot(in + i));
        if (last)
          dst[base + i] = finish(a.op, v, n);
        else
          store_slot(next + i, v);
      }
      publish(my_ack, t + 1);
      if (!last) publish(right_recv, t + 2);
    }
  }
}

template <typename T>
__device__ void allgather_body(const RsAgArgs& a) {
  __shared__ int abort_flag;
  const int n = a.n;
  const int r = blockIdx.y;
  const int c = blockIdx.x;
  const int right = (r + 1) % n;
  const long long blk = a.blk;
  const long long cblk = a.cblk;
  long long lo, lane_hi;
  lane_slice(cblk, &lo, &lane_hi);
  const T* src = static_cast<const T*>(a.ptrs[r]);
  T* dst = static_cast<T*>(a.ptrs[n + r]);          // n blocks of blk
  T* right_dst = static_cast<T*>(a.ptrs[n + right]);
  T* own = dst + (long long)r * blk;
  unsigned* my_recv = a.flags + ((size_t)r * gridDim.x + c) * 2;
  unsigned* right_recv = a.flags + ((size_t)right * gridDim.x + c) * 2;

  if (threadIdx.x == 0) abort_flag = 0;
  __syncthreads();
  for (int k = 0; k < a.n_chunks; ++k) {
    const long long base = (long long)k * cblk;
    const long long hi = min(lane_hi, blk - base);  // real elements only
    // step 0: my own block, into my dst (unless in place) and the right
    // neighbour's
    const long long mine = (long long)r * blk + base;
    for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      T v = src[base + i];
      if (src != own) own[base + i] = v;
      if (n > 1) store_slot(right_dst + mine + i, v);
    }
    if (n == 1) continue;
    // message u+s is step s's block; counters run over the whole launch
    const unsigned u = (unsigned)k * (n - 1);
    publish(right_recv, u + 1);
    // step s forwards block r-s, which the left neighbour sent at step s-1
    for (int s = 1; s < n - 1; ++s) {
      if (!wait_geq(my_recv, u + s, a.err, &abort_flag)) return;
      const long long off = (long long)mod(r - s, n) * blk + base;
      for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x)
        store_slot(right_dst + off + i, load_slot(dst + off + i));
      publish(right_recv, u + s + 1);
    }
  }
  // the last block of each chunk is not forwarded; waiting for the last of
  // all still reports a left neighbour that never signalled
  if (n > 1)
    wait_geq(my_recv, (unsigned)a.n_chunks * (n - 1), a.err, &abort_flag);
}

template <typename T>
__global__ void ring_reduce_scatter_pass_kernel(RsAgArgs a) {
  reduce_scatter_body<T>(a);
}

template <typename T>
__global__ void ring_reduce_scatter_chunked_kernel(RsAgArgs a) {
  reduce_scatter_body<T>(a);
}

template <typename T>
__global__ void ring_allgather_pass_kernel(RsAgArgs a) {
  allgather_body<T>(a);
}

template <typename T>
__global__ void ring_allgather_chunked_kernel(RsAgArgs a) {
  allgather_body<T>(a);
}

template <typename T>
const void* kernel_for(int kernel) {
  switch (kernel) {
    case K_RS_PASS: return (const void*)ring_reduce_scatter_pass_kernel<T>;
    case K_RS_CHUNKED:
      return (const void*)ring_reduce_scatter_chunked_kernel<T>;
    case K_AG_PASS: return (const void*)ring_allgather_pass_kernel<T>;
    case K_AG_CHUNKED: return (const void*)ring_allgather_chunked_kernel<T>;
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
int ucc_ring_rs_ag_max_ctas(int kernel, int dtype, int threads, int* out) {
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

// Launch one ring reduce_scatter or allgather on `stream`; returns
// cudaGetLastError() after the launch (0 on success). `root` is part of the
// common interface and unused here.
int ucc_ring_rs_ag(int kernel, int dtype, void* const* ptrs, void* comm,
                   unsigned* flags, int* err, long long blk, long long cblk,
                   int n_chunks, int n, int op, int root, int lanes,
                   int threads, cudaStream_t stream) {
  (void)root;
  const void* kern = select_kernel(kernel, dtype);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  RsAgArgs a{ptrs, comm, flags, err, blk, cblk, n_chunks, n, op};
  void* params[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(kern, dim3(lanes, n),
                                              dim3(threads), params, 0,
                                              stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* ucc_ring_rs_ag_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
