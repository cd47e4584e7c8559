// Bcast over the n ranks of one GPU, as one flag-free pass from the root's
// src.
//
// Replaces the Pallas kernels of the JAX package:
//   ring_bcast_pass     <- ucc_tpu/tl/ring_dma.py:_bcast_kernel
//                          (build_bcast_program);
//   ring_bcast_chunked  <- ucc_tpu/tl/ring_dma.py:_hbm_bcast_kernel
//                          (build_hbm_bcast_program).
// Both entry points launch the one kernel below with the same arguments:
// a bcast only copies, so its result depends on no sub-block size.
//
// What it computes. For every rank r != root and every i < count,
//   dst_r[i] = src_root[i];
// the root's dst gets the same values only when it is not the root's src.
// UCC's bcast passes src alone, and then the root's buffer is its result
// and is never written. Non-root srcs are never read. Every element moves
// as raw bits (direct_fold.cuh's Raw<B>), in 16-byte uint4 vectors or as
// an unsigned integer of its width: no float register touches it, so NaN
// payloads and -0.0 arrive as the root holds them. This is the ring's
// copy: the plain version (ucc_tpu_torch/kernels/ring_bcast_a2a.py:
// ring_bcast_ref) and the Pallas kernels in interpret mode, bit for bit.
// A copy has no arithmetic, so the kernel is built once per element width
// (1, 2, 4 and 8 bytes), not once per dtype.
//
// Walk. One ordinary launch of a 1-D grid sized from the occupancy query
// (kernels/ring_common.py: launch_ctas over count): no flags, no error
// word, no spin, no cooperative launch and no co-residency rule, so any n
// runs. The grid walks the root's src grid-stride in 16-byte vectors
// (direct_fold.cuh's load and store, ld.global.cs.v4 / st.global.cs.v4). A
// thread issues the loads of its BCAST_UNROLL vectors v, v + stride, ...
// first, then stores each of them into every dst in turn, so each warp
// store is 512 contiguous bytes of one dst. Nothing is read back from a
// dst.
//
// Pointers and alignment. A CTA stages the n dst pointers in shared memory
// up to SMEM_RANKS ranks and reads them from global memory above that.
// Only the root's src and the n dsts decide the path, since non-root srcs
// are arbitrary and unread: when those n + 1 pointers share one offset mod
// 16, the elements before the first 16-byte boundary (the head) and after
// the last whole vector (the tail) go one at a time and the rest as
// vectors; otherwise every element goes one at a time.
//
// What bounds it: bytes. A bcast must read the root's S bytes once and
// write n - 1 copies (n when the root is not in place), n * S in all
// (0.1603 ms at 3.35 TB/s for 8 ranks of 64 MiB); the kernel moves exactly
// that. The ring it replaces read every forwarded sub-block back from the
// rank that had just received it ((n - 2) * S more) and spun on a step
// counter per sub-block. The workspace (comm slots, flags, error word) is
// not used.
//
// Across processes (ROADMAP A5) the same pointer table of CUDA IPC peer
// pointers is a direct push from the root's src, with two all-rank
// barriers around the pass, which inside one process the stream provides:
// one on entry (the root's src is ready) and one on exit (no peer still
// reads the root's src or writes my dst when my launch ends).

#include "direct_fold.cuh"

namespace {

// vectors a thread loads before it stores any (tools/bcast_depth.py times
// other depths)
constexpr int BCAST_UNROLL = 8;

struct Args {
  void* const* ptrs;   // device array: n src pointers, then n dst pointers
  long long count;     // elements per rank
  int n;
  int root;
};

// The buffers a bcast touches: the root's src and the n dsts (staged in
// shared memory or in global memory); `skip` is the root when its dst is
// its src (nothing to write there), else -1.
struct Dsts {
  const void* src;
  void* const* dst;
  int n;
  int skip;
};

// The launch's buffers, the n dst pointers staged in `staged` when n <=
// SMEM_RANKS, and whether every element may take the vector path:
// `aligned` when the root's src and the n dsts lie at one offset mod 16,
// with `head` the elements before the first 16-byte boundary (at most
// `count`). Unlike stage_table, no non-root src is read. Every thread of
// the CTA calls it.
template <typename U>
__device__ __forceinline__ Dsts stage_bcast_table(const Args& a,
                                                  void** staged,
                                                  bool& aligned,
                                                  long long& head) {
  const int n = a.n;
  const void* src = a.ptrs[a.root];
  const uintptr_t mis = reinterpret_cast<uintptr_t>(src) & 15;
  int odd = mis % sizeof(U) != 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    void* p = a.ptrs[n + i];
    if (n <= SMEM_RANKS) staged[i] = p;
    odd |= (reinterpret_cast<uintptr_t>(p) & 15) != mis;
  }
  aligned = !__syncthreads_or(odd);  // also publishes `staged`
  head = min(a.count, (long long)((16 - mis) & 15) / (long long)sizeof(U));
  void* const* dst = n <= SMEM_RANKS ? staged : a.ptrs + n;
  return Dsts{src, dst, n, dst[a.root] == src ? a.root : -1};
}

// Elements [lo, hi) one at a time, grid-stride.
template <typename U>
__device__ void copy_elements(const Dsts& t, long long lo, long long hi) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const U* src = static_cast<const U*>(t.src);
  for (long long i = lo + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < hi; i += stride) {
    const U x = src[i];
    for (int r = 0; r < t.n; ++r)
      if (r != t.skip) static_cast<U*>(t.dst[r])[i] = x;
  }
}

// Vectors 0 .. vecs-1 of W elements, vector v at element lo + v * W of
// every buffer. Thread `first` of the grid takes vectors first,
// first + stride, ..., BCAST_UNROLL of them per iteration: all their loads,
// then their stores dst by dst.
template <typename U, int W>
__device__ void copy_vectors(const Dsts& t, long long lo, long long vecs) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const U* src = static_cast<const U*>(t.src) + lo;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       v < vecs; v += BCAST_UNROLL * stride) {
    Pack<U, W> x[BCAST_UNROLL];
#pragma unroll
    for (int k = 0; k < BCAST_UNROLL; ++k)
      if (v + k * stride < vecs)
        x[k] = load<U, W>(src + (v + k * stride) * W);
    for (int r = 0; r < t.n; ++r) {
      if (r == t.skip) continue;
      U* dst = static_cast<U*>(t.dst[r]) + lo;
#pragma unroll
      for (int k = 0; k < BCAST_UNROLL; ++k)
        if (v + k * stride < vecs)
          store<U, W>(dst + (v + k * stride) * W, x[k]);
    }
  }
}

// The bcast of elements of B bytes.
template <int B>
__global__ void __launch_bounds__(THREADS) bcast_kernel(Args a) {
  using U = typename Raw<B>::U;
  constexpr int W = 16 / B;
  __shared__ void* staged[SMEM_RANKS];
  bool aligned;
  long long head;
  const Dsts t = stage_bcast_table<U>(a, staged, aligned, head);
  if (!aligned) {
    copy_elements<U>(t, 0, a.count);
    return;
  }
  const long long vecs = (a.count - head) / W;
  const long long tail = head + vecs * W;
  copy_vectors<U, W>(t, head, vecs);
  copy_elements<U>(t, 0, head);
  copy_elements<U>(t, tail, a.count);
}

const void* select_kernel(int dtype) {
  switch (dtype) {
    case DT_I8:
    case DT_U8: return (const void*)bcast_kernel<1>;
    case DT_F16:
    case DT_BF16:
    case DT_I16: return (const void*)bcast_kernel<2>;
    case DT_F32:
    case DT_I32: return (const void*)bcast_kernel<4>;
    case DT_I64:
    case DT_F64: return (const void*)bcast_kernel<8>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Most CTAs of `threads` threads that can be resident at once for the
// kernel of `dtype`'s width (SMs x blocks per SM): the grid's size.
// `kernel` is part of the common interface; both entry points share one
// kernel.
int ucc_bcast_max_ctas(int kernel, int dtype, int threads, int* out) {
  (void)kernel;
  const void* kern = select_kernel(dtype);
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

// Launch one bcast of `count` elements per rank from `root` on `stream`, on
// a grid of `ctas` CTAs of `threads` threads; returns cudaGetLastError()
// after the launch (0 on success). The signature is the common one of the
// ring sources: the kernel uses no comm slots, flag words, error word or
// op, and `cblk` and `n_chunks` do not apply.
int ucc_bcast(int kernel, int dtype, void* const* ptrs, void* comm,
              unsigned* flags, int* err, long long count, long long cblk,
              int n_chunks, int n, int op, int root, int ctas, int threads,
              cudaStream_t stream) {
  (void)kernel, (void)comm, (void)flags, (void)err, (void)cblk,
      (void)n_chunks, (void)op;
  const void* kern = select_kernel(dtype);
  if (kern == nullptr || n < 1 || root < 0 || root >= n || count < 1 ||
      ctas < 1)
    return (int)cudaErrorInvalidValue;
  Args a{ptrs, count, n, root};
  void* params[] = {&a};
  cudaError_t e = cudaLaunchKernel(kern, dim3(ctas), dim3(threads), params,
                                   0, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* ucc_bcast_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
