// Ring allgather over the n ranks of one GPU, as one kernel launch.
//
// Replaces the Pallas ring kernels of the JAX package:
//   ring_allgather_pass    <- ucc_tpu/tl/ring_dma.py:_ring_kernel in
//                             allgather mode (build_ring_program);
//   ring_allgather_chunked <- ucc_tpu/tl/ring_dma.py:_hbm_allgather_kernel.
// A pass entry is the one-chunk case of its chunked twin (cblk = blk); the
// two share a body. The CTA-pair flag protocol is that of ring_common.cuh.
//
// The ring reduce_scatter kernels that this source held until they were
// redesigned (ring_reduce_scatter_pass, ring_reduce_scatter_chunked) are
// in reduce_scatter.cu: one flag-free pass over the ranks' srcs, with no
// comm slots, flags or cooperative launch.
//
// What it computes. Every rank's per-rank block holds blk elements; a
// chunk is the same cblk-element sub-range of every block, and chunks run
// one after another, each a ring of its own. Rank r's dst is the n blocks
// in rank order; block b leaves rank b and is forwarded n-1 times around
// the ring. Copies only, so the result is bitwise torch.cat, and the plain
// PyTorch version in ucc_tpu_torch/kernels/ring_rs_ag.py
// (ring_allgather_ref).
//
// Design. CTA (r, c) plays rank r on lane slice c of every chunk and talks
// only to CTAs (r-1, c) and (r+1, c), with release/acquire step counters,
// bounded spins and a sticky error word; the launch is cooperative, so
// every CTA is resident. A CTA stores straight into the right neighbour's
// dst block: every dst block is written exactly once, so the ring needs no
// comm slots, their 2-slot parity or a consumer ack, only the step counter
// that says a block has arrived and may be forwarded. In place (src =
// block r of dst) skips the copy of the own block.
//
// What bounds it: bytes. The least traffic is each input read once and
// each output written once, n*S read and n*(n*S) written for S bytes of
// src per rank. On top of that the ring reads each forwarded block back
// ((n-2)*S per rank). With chunks of CHUNK_ELEMS / n elements per block,
// the blocks of one chunk step over all ranks stay in the 50 MB L2, so
// that extra traffic need not reach HBM.
//
// This first version is plain: scalar loads and stores, one handshake per
// step per CTA.

#include "ring_common.cuh"

namespace {

// kernel ids of ucc_tpu_torch/kernels/ring_rs_ag.py
constexpr int K_AG_PASS = 0;
constexpr int K_AG_CHUNKED = 1;

struct AgArgs {
  void* const* ptrs;   // device array: n src pointers, then n dst pointers
  unsigned* flags;     // n ranks x C lanes x {recv counter, ack counter}
  int* err;            // sticky error word
  long long blk;       // elements of one rank-block
  long long cblk;      // elements of a block in one chunk
  int n_chunks;        // ceil(blk / cblk)
  int n;
};

// Lane slice [lo, hi) of a chunk's block that this CTA handles.
__device__ void lane_slice(long long cblk, long long* lo, long long* hi) {
  const long long lane = (cblk + gridDim.x - 1) / gridDim.x;
  *lo = min(cblk, (long long)blockIdx.x * lane);
  *hi = min(cblk, *lo + lane);
}

template <typename T>
__device__ void allgather_body(const AgArgs& a) {
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
__global__ void ring_allgather_pass_kernel(AgArgs a) {
  allgather_body<T>(a);
}

template <typename T>
__global__ void ring_allgather_chunked_kernel(AgArgs a) {
  allgather_body<T>(a);
}

template <typename T>
const void* kernel_for(int kernel) {
  switch (kernel) {
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

// Launch one ring allgather on `stream`; returns cudaGetLastError() after
// the launch (0 on success). `comm`, `op` and `root` are part of the common
// interface and unused here.
int ucc_ring_rs_ag(int kernel, int dtype, void* const* ptrs, void* comm,
                   unsigned* flags, int* err, long long blk, long long cblk,
                   int n_chunks, int n, int op, int root, int lanes,
                   int threads, cudaStream_t stream) {
  (void)comm, (void)op, (void)root;
  const void* kern = select_kernel(kernel, dtype);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  AgArgs a{ptrs, flags, err, blk, cblk, n_chunks, n};
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
