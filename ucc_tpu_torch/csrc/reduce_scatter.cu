// Reduce_scatter over the n ranks of one GPU, as one flag-free pass over
// the ranks' srcs.
//
// Replaces the Pallas ring kernels of the JAX package:
//   ring_reduce_scatter_pass    <- ucc_tpu/tl/ring_dma.py:_ring_kernel in
//                                  reduce_scatter mode (build_ring_program);
//   ring_reduce_scatter_chunked <- ucc_tpu/tl/ring_dma.py:
//                                  _hbm_reduce_scatter_kernel, the same ring
//                                  once per chunk.
// Both entry points launch the one kernel below with the same arguments:
// the ring's result does not depend on the chunk size.
//
// What it computes. Rank r's src is n blocks of blk elements, its dst is
// block r of the reduction. The ring of the TPU kernel (shift c = 1 of
// _ring_reduce_steps) sends block r-1 from rank r and folds the incoming
// message into the local block as acc(local, incoming), so rank r's dst
// ends as
//   dst_r[i] = acc(x_r, acc(x_{r-1}, ... acc(x_{r+2}, x_{r+1})))
//              where x_q = src_q[r * blk + i], ranks mod n,
// and AVG divides that by n at the end (Elem<T>::avg). This is the fold
// order of the plain version in ucc_tpu_torch/kernels/ring_rs_ag.py
// (ring_reduce_scatter_ref) and of the Pallas kernels in interpret mode:
// the allreduce's fold of block r, started one rank later. An element
// depends on that element of the n srcs and on nothing else, and the
// ring's messages only carried the partial folds from rank to rank. So a
// thread that loads x_{r+1} ... x_r of an element, folds them in that
// order with accumulate() of ring_common.cuh, divides for AVG and stores
// the result into dst_r computes the same bits: the same operations on the
// same operands in the same order. 16-bit floats round after every
// operation, integers wrap, MAX and MIN keep the operand order that decides
// which NaN survives, and the library is built without --use_fast_math.
//
// What bounds it: bytes. The least traffic is each src read once and each
// dst written once, n * (n * S) + n * S bytes for S bytes of dst per rank
// (0.1803 ms at 3.35 TB/s for 8 ranks of 64 MiB in). This kernel moves
// exactly that: nothing goes through comm slots.
//
// Design. Grid row blockIdx.x = r computes dst_r; its gridDim.y CTAs walk
// that block grid-stride, so the rank needs no division and a vector never
// straddles two output blocks. No CTA waits on another: there are no
// flags, no error word, no spin and no cooperative launch, and any n runs
// (gridDim.x takes 2^31 - 1 rows). The work unit is one 16-byte vector per
// rank (ld.global.cs.v4 / st.global.cs.v4, with the pointer table, the
// vectors and the fold of direct_fold.cuh, shared with ring_allreduce.cu);
// a thread takes UNROLL vectors at a time and issues the loads of GROUP
// ranks for all of them before their folds.
//
// Alignment is decided per output block. Block r reads src_q + r * blk and
// writes dst_r + 0; when blk * sizeof(T) is no multiple of 16 the offsets
// mod 16 of the srcs' block r change with r while dst_r's do not. So each
// row checks its n + 1 pointers itself (__syncthreads_or): when they share
// one offset mod 16, the elements before the first 16-byte boundary and
// after the last whole vector go one at a time and the rest as vectors;
// when they do not, every element of the block goes one at a time.
//
// In place, src_r is the whole dst vector of rank r and dst_r its block r.
// That stays safe: the thread of element i of block r reads element i of
// block r of every src, and block q of src_q is dst_q, so the only one of
// those n elements that any thread writes is src_r's, dst_r[i], and the
// thread that writes it is this one, after it has read all n.
//
// Across GPUs (ROADMAP A5) the same table of peer pointers is the direct
// reduce_scatter: rank r reads its block from the n peers' srcs, which moves
// (n-1)/n * n * S over the links per rank, as the ring does. Across
// processes it needs an all-rank barrier on entry (every src is ready) and
// one before a src is reused (every peer has read it); inside one process
// the stream orders both.

#include "direct_fold.cuh"

namespace {

struct Args {
  void* const* ptrs;   // device array: n src pointers, then n dst pointers
  long long blk;       // elements of one dst; a src holds n blocks of blk
  int n;
  int op;
};

// Element i of block r (at = r * blk in every src), rank by rank from rank
// r+1 round the ring: the path of single elements.
template <typename T, int OP>
__device__ __noinline__ void fold_element(Table t, int r, long long at,
                                          long long i) {
  const int n = t.n;
  int q = r + 1 == n ? 0 : r + 1;
  T v = t.src<T>(q)[at + i];
  for (int k = 1; k < n; ++k) {
    if (++q == n) q = 0;
    v = accumulate(OP, t.src<T>(q)[at + i], v);
  }
  if (OP == OP_AVG) v = Elem<T>::avg(v, n);
  t.dst<T>(r)[i] = v;
}

// Elements lo .. lo+count-1 of block r one at a time, walked grid-stride
// by the row's CTAs.
template <typename T, int OP>
__device__ void sweep_elements(const Table& t, int r, long long at,
                               long long lo, long long count) {
  const long long stride = (long long)gridDim.y * blockDim.x;
  const long long first = (long long)blockIdx.y * blockDim.x + threadIdx.x;
  for (long long i = lo + first; i < lo + count; i += stride)
    fold_element<T, OP>(t, r, at, i);
}

// Vectors 0 .. units-1 of W elements each of block r, vector u at element
// lo + u * W. Thread `first` of the row takes vectors first,
// first + stride, ..., UNROLL of them per iteration.
template <typename T, int OP, int W>
__device__ void sweep(const Table& t, int r, long long at, long long lo,
                      long long units) {
  const long long stride = (long long)gridDim.y * blockDim.x;
  const long long first = (long long)blockIdx.y * blockDim.x + threadIdx.x;
  const int n = t.n;
  const int start = r + 1 == n ? 0 : r + 1;  // the ring's first rank
  T* dst = t.dst<T>(r);
  for (long long u = first; u < units; u += UNROLL * stride) {
    bool live[UNROLL];
    Pack<T, W> acc[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) live[k] = u + k * stride < units;
    for (int base = 0; base < n; base += GROUP) {
      Pack<T, W> x[GROUP][UNROLL];
#pragma unroll
      for (int i = 0; i < GROUP; ++i)
#pragma unroll
        for (int k = 0; k < UNROLL; ++k)
          if (base + i < n && live[k]) {
            int q = start + base + i;  // < 2n: the ring from rank r+1 on
            if (q >= n) q -= n;
            x[i][k] = load<T, W>(t.src<T>(q) + at + lo +
                                 (u + k * stride) * W);
          }
#pragma unroll
      for (int i = 0; i < GROUP; ++i)
#pragma unroll
        for (int k = 0; k < UNROLL; ++k)
          if (base + i < n && live[k]) {
            if (base + i == 0)
              acc[k] = x[i][k];
            else
              fold<OP>(acc[k], x[i][k]);
          }
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k)
      if (live[k]) {
        if (OP == OP_AVG) {
#pragma unroll
          for (int l = 0; l < W; ++l)
            acc[k].e[l] = Elem<T>::avg(acc[k].e[l], n);
        }
        store<T, W>(dst + lo + (u + k * stride) * W, acc[k]);
      }
  }
}

// Every element of the row's block r: 16-byte vectors where its pointers
// allow, single elements at the head, at the tail and everywhere when they
// do not.
template <typename T, int OP>
__device__ void reduce_block(const Table& t, const Args& a, bool aligned,
                             long long head) {
  constexpr int W = 16 / sizeof(T);
  const int r = blockIdx.x;
  const long long at = (long long)r * a.blk;  // block r of every src
  if (!aligned) {
    sweep_elements<T, OP>(t, r, at, 0, a.blk);
    return;
  }
  const long long vecs = (a.blk - head) / W;
  const long long tail = head + vecs * W;
  sweep<T, OP, W>(t, r, at, head, vecs);
  sweep_elements<T, OP>(t, r, at, 0, head);
  sweep_elements<T, OP>(t, r, at, tail, a.blk - tail);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) reduce_scatter_kernel(Args a) {
  __shared__ void* staged[2 * SMEM_RANKS];
  const int n = a.n;
  const long long at = (long long)blockIdx.x * a.blk;
  // the vector path needs block r of every src and dst r at one offset
  // mod 16 (r = blockIdx.x)
  const uintptr_t mis =
      reinterpret_cast<uintptr_t>(a.ptrs[n + blockIdx.x]) & 15;
  int odd = mis % sizeof(T) != 0;
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) {
    void* p = a.ptrs[i];
    if (n <= SMEM_RANKS) staged[i] = p;
    if (i < n)
      odd |= (reinterpret_cast<uintptr_t>(static_cast<const T*>(p) + at) &
              15) != mis;
  }
  const bool aligned = !__syncthreads_or(odd);  // also publishes `staged`
  const long long head =
      min(a.blk, (long long)((16 - mis) & 15) / (long long)sizeof(T));
  const Table t{n <= SMEM_RANKS ? staged : a.ptrs, n};
  switch (a.op) {
    case OP_SUM: reduce_block<T, OP_SUM>(t, a, aligned, head); break;
    case OP_PROD: reduce_block<T, OP_PROD>(t, a, aligned, head); break;
    case OP_MAX: reduce_block<T, OP_MAX>(t, a, aligned, head); break;
    case OP_MIN: reduce_block<T, OP_MIN>(t, a, aligned, head); break;
    case OP_AVG: reduce_block<T, OP_AVG>(t, a, aligned, head); break;
  }
}

const void* select_kernel(int dtype) {
  switch (dtype) {
    case DT_F32: return (const void*)reduce_scatter_kernel<float>;
    case DT_F16: return (const void*)reduce_scatter_kernel<__half>;
    case DT_BF16: return (const void*)reduce_scatter_kernel<__nv_bfloat16>;
    case DT_I32: return (const void*)reduce_scatter_kernel<int>;
    case DT_I64: return (const void*)reduce_scatter_kernel<long long>;
    case DT_I8: return (const void*)reduce_scatter_kernel<signed char>;
    case DT_U8: return (const void*)reduce_scatter_kernel<unsigned char>;
    case DT_I16: return (const void*)reduce_scatter_kernel<short>;
    case DT_F64: return (const void*)reduce_scatter_kernel<double>;
    default: return nullptr;
  }
}

bool known_op(int op) {
  return op == OP_SUM || op == OP_PROD || op == OP_MAX || op == OP_MIN ||
         op == OP_AVG;
}

}  // namespace

extern "C" {

// Most CTAs of `threads` threads that can be resident at once for the
// kernel of `dtype` (SMs x blocks per SM), which the n rows of a launch
// share. `chunked` is part of the common interface; both entry points
// share one kernel.
int ucc_reduce_scatter_max_ctas(int chunked, int dtype, int threads,
                                int* out) {
  (void)chunked;
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

// Launch one reduce_scatter of n blocks of `blk` elements per src on
// `stream`, on a grid of n rows of `ctas` CTAs of `threads` threads;
// returns cudaGetLastError() after the launch (0 on success). The
// signature is the common one of the ring sources: the kernel uses no comm
// slots, flag words or error word, and `cblk`, `n_chunks` and `root` do
// not apply.
int ucc_reduce_scatter(int chunked, int dtype, void* const* ptrs, void* comm,
                       unsigned* flags, int* err, long long blk,
                       long long cblk, int n_chunks, int n, int op, int root,
                       int ctas, int threads, cudaStream_t stream) {
  (void)chunked, (void)comm, (void)flags, (void)err, (void)cblk,
      (void)n_chunks, (void)root;
  const void* kern = select_kernel(dtype);
  if (kern == nullptr || !known_op(op) || n < 1 || blk < 1 || ctas < 1 ||
      ctas > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{ptrs, blk, n, op};
  void* params[] = {&a};
  cudaError_t e = cudaLaunchKernel(kern, dim3(n, ctas), dim3(threads),
                                   params, 0, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* ucc_reduce_scatter_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
