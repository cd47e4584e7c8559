// Allreduce over the n ranks of one GPU, as one flag-free pass over the
// ranks' buffers.
//
// Replaces the Pallas ring kernels of the JAX package:
//   ring_allreduce_pass    <- ucc_tpu/tl/ring_dma.py:_ring_kernel (allreduce
//                             mode), the one-pass ring built by
//                             build_ring_program;
//   ring_allreduce_chunked <- ucc_tpu/tl/ring_dma.py:_hbm_allreduce_kernel,
//                             the same ring once per chunk.
// Both entry points launch the one kernel below. They differ only in the
// geometry the wrapper passes: the pass entry has blk = ceil(count / n)
// (one chunk), the chunked one blk = csize / n for csize = pass_elems(n).
//
// What it computes. Rank r holds count elements, cut into chunks of
// csize = n * blk elements and each chunk into n blocks of blk. The ring
// of the TPU kernel folds block b first on rank b+1, then on b+2, and so
// on round the ring, with acc(local, incoming): element g of block
// b = (g mod csize) / blk ends as
//   acc(x_{b-1}, acc(x_{b-2}, ... acc(x_{b+1}, x_b)))      (ranks mod n)
// on every rank, and AVG divides that by n at the end (Elem<T>::avg).
// This is the fold order of the plain version in
// ucc_tpu_torch/kernels/ring_allreduce.py (ring_allreduce_ref) and of the
// Pallas kernels in interpret mode. The result of an element depends on
// that element of the n srcs and on nothing else, and the messages of the
// ring only carried the partial folds from rank to rank. So a thread that
// loads x_b ... x_{b-1} of an element, folds them in that order with
// accumulate() of ring_common.cuh, divides for AVG and stores the result
// into all n dsts computes the same bits: the same operations on the same
// operands in the same order. 16-bit floats round after every operation
// (Elem<T>::add rounds each sum to the type, never an f32 running sum),
// integers wrap, MAX and MIN keep the operand order that decides which
// NaN survives, and the library is built without --use_fast_math, so no
// division becomes a reciprocal and no sum is contracted.
//
// What bounds it: bytes. The least traffic is each src read once and each
// dst written once, 2 * n * S bytes for S bytes per rank (0.3205 ms at
// 3.35 TB/s for 8 ranks of 64 MiB). This kernel moves exactly that.
//
// Design. A 1-D grid sized from the occupancy query walks the elements
// grid-stride; no CTA waits on another, so there are no flags, no error
// word and no cooperative launch. A thread owns an element in every
// buffer: it reads all n values before it writes any, which keeps in place
// (src == dst) safe. The work unit is one 16-byte vector per rank
// (ld.global.cs.v4 / st.global.cs.v4: every byte is used once; the vectors,
// the pointer table and the fold are direct_fold.cuh's, shared with
// reduce_scatter.cu); a thread takes UNROLL vectors at a time and issues
// the loads of GROUP ranks for all of them before their folds. A vector
// knows its block from an offset and a block index that the thread
// advances by a fixed step, so the loop does no division. Edges stay in
// the kernel:
//   - a vector that straddles a block boundary (the chunked kernel's blk
//     is odd for n = 3 and 5 and no multiple of 8 for n = 7, and blk may
//     be shorter than a vector) folds element by element, each with its
//     own block;
//   - the elements before the first 16-byte boundary and after the last
//     whole vector take the same path one element at a time;
//   - when the 2n pointers do not share one offset mod 16 (tensor views
//     with a storage offset), every element takes it.
//
// Across processes of one host (tl/device_sync.py) the table mixes this
// process's pointers with CUDA IPC mappings of its peers' buffers, and
// each process folds one part [lo, hi) of the elements into all n dsts:
// an element's fold order depends on its index alone, so the union of the
// parts is bitwise the single launch, and each src is still read once and
// each dst written once, by one process. The rounds are ordered on the
// streams by interprocess CUDA events, not inside the kernel. Across GPUs
// (ROADMAP A5) the same table of 2n peer pointers serves as the two-shot
// allreduce: rank r reduces the blocks it owns from the peers' srcs and
// pushes the result into the peers' dsts, which moves 2(n-1)/n * S over
// the links per rank, as the ring does.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700.00 W
// power limit, 8 ranks: 16 Mi f32 per rank 0.379 ms, 0.85 of the bound
// (the ring kernel: 3.755 ms; torch.stack(srcs).sum(0): 0.559 ms); 64 Ki
// f32 per rank 0.0051 ms (the ring kernel: 0.0718 ms; the library call:
// 0.0070 ms). Vector loads and stores were kept: at 0.85 of the bound they
// passed the 0.8 below which TMA bulk copies (cp.async.bulk behind
// mbarriers) were to be tried, so no TMA version was built or timed.

#include "direct_fold.cuh"

namespace {

struct Args {
  void* const* ptrs;   // device array: n src pointers, then n dst pointers
  long long count;     // elements per rank
  long long blk;       // elements per block; a chunk is n blocks
  long long lo, hi;    // the part of the elements this launch folds
  int n;
  int op;
};

// One element g of block b, rank by rank: the path of single elements
// and of each element of a vector that straddles a block boundary.
template <typename T, int OP>
__device__ __noinline__ void fold_element(Table t, int b, long long g) {
  const int n = t.n;
  T v = t.src<T>(b)[g];
  for (int i = 1; i < n; ++i) {
    int r = b + i;
    if (r >= n) r -= n;
    v = accumulate(OP, t.src<T>(r)[g], v);
  }
  if (OP == OP_AVG) v = Elem<T>::avg(v, n);
  for (int r = 0; r < n; ++r) t.dst<T>(r)[g] = v;
}

// Elements lo .. lo+count-1 of every rank one at a time, grid-stride,
// each thread advancing its element's offset in its block and that
// block's index in its chunk without a division.
template <typename T, int OP>
__device__ void sweep_elements(const Table& t, long long blk, long long lo,
                               long long count) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (first >= count) return;
  const int n = t.n;
  long long q = (lo + first) / blk;
  long long off = lo + first - q * blk;
  int b = (int)(q % n);
  const long long step_q = stride / blk;
  const long long step_off = stride - step_q * blk;
  const int step_b = (int)(step_q % n);
  for (long long g = lo + first; g < lo + count; g += stride) {
    fold_element<T, OP>(t, b, g);
    off += step_off;
    b += step_b;
    if (off >= blk) {
      off -= blk;
      b += 1;
    }
    if (b >= n) b -= n;
  }
}

// Vectors 0 .. units-1 of W elements each, vector u at element lo + u * W
// of every rank. Thread `first` of the grid takes vectors first,
// first + stride, ..., UNROLL of them per iteration.
template <typename T, int OP, int W>
__device__ void sweep(const Table& t, long long blk, long long lo,
                      long long units) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (first >= units) return;
  const int n = t.n;
  // of each of the thread's UNROLL units: the offset of its first element
  // in its block and that block's index in its chunk, both advanced by
  // `step` elements an iteration without a division
  long long off[UNROLL];
  int b[UNROLL];
#pragma unroll
  for (int k = 0; k < UNROLL; ++k) {
    const long long e = lo + (first + k * stride) * W;
    const long long q = e / blk;
    off[k] = e - q * blk;
    b[k] = (int)(q % n);
  }
  const long long step = UNROLL * stride * W;
  const long long step_q = step / blk;
  const long long step_off = step - step_q * blk;
  const int step_b = (int)(step_q % n);

  for (long long u = first; u < units; u += UNROLL * stride) {
    bool whole[UNROLL];  // a live unit inside one block
    Pack<T, W> acc[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k)
      whole[k] = u + k * stride < units && off[k] + W <= blk;
    for (int base = 0; base < n; base += GROUP) {
      Pack<T, W> x[GROUP][UNROLL];
#pragma unroll
      for (int i = 0; i < GROUP; ++i)
#pragma unroll
        for (int k = 0; k < UNROLL; ++k)
          if (base + i < n && whole[k]) {
            int r = b[k] + base + i;  // < 2n: the ring from rank b on
            if (r >= n) r -= n;
            x[i][k] = load<T, W>(t.src<T>(r) + lo + (u + k * stride) * W);
          }
#pragma unroll
      for (int i = 0; i < GROUP; ++i)
#pragma unroll
        for (int k = 0; k < UNROLL; ++k)
          if (base + i < n && whole[k]) {
            if (base + i == 0)
              acc[k] = x[i][k];
            else
              fold<OP>(acc[k], x[i][k]);
          }
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const long long e = lo + (u + k * stride) * W;
      if (whole[k]) {
        if (OP == OP_AVG) {
#pragma unroll
          for (int l = 0; l < W; ++l)
            acc[k].e[l] = Elem<T>::avg(acc[k].e[l], n);
        }
        for (int r = 0; r < n; ++r) store<T, W>(t.dst<T>(r) + e, acc[k]);
      } else if (u + k * stride < units) {
        long long o = off[k];
        int bb = b[k];
        for (int l = 0; l < W; ++l) {
          fold_element<T, OP>(t, bb, e + l);
          if (++o == blk) {
            o = 0;
            if (++bb == n) bb = 0;
          }
        }
      }
      off[k] += step_off;
      b[k] += step_b;
      if (off[k] >= blk) {
        off[k] -= blk;
        b[k] += 1;
      }
      if (b[k] >= n) b[k] -= n;
    }
  }
}

// Elements [lo, hi) of every rank: 16-byte vectors where the pointers
// allow, single elements at the head, at the tail and everywhere when they
// do not. PART: a launch of one part of the elements (a team across
// processes); the whole walk, [0, count) (PART false), keeps the code of a
// launch without parts.
template <typename T, int OP, bool PART>
__device__ void allreduce(const Table& t, const Args& a, bool aligned,
                          long long head) {
  constexpr int W = 16 / sizeof(T);
  if (!aligned) {
    sweep_elements<T, OP>(t, a.blk, a.lo, a.hi - a.lo);
    return;
  }
  if (!PART) {
    const long long vecs = (a.count - head) / W;
    const long long tail = head + vecs * W;
    sweep<T, OP, W>(t, a.blk, head, vecs);
    sweep_elements<T, OP>(t, a.blk, 0, head);
    sweep_elements<T, OP>(t, a.blk, tail, a.count - tail);
    return;
  }
  const Part p = vector_part(a.lo, a.hi, head, W);
  const long long tail = p.v0 + p.vecs * W;
  sweep<T, OP, W>(t, a.blk, p.v0, p.vecs);
  sweep_elements<T, OP>(t, a.blk, a.lo, p.v0 - a.lo);
  sweep_elements<T, OP>(t, a.blk, tail, a.hi - tail);
}

template <typename T, bool PART>
__global__ void __launch_bounds__(THREADS) ring_allreduce_kernel(Args a) {
  __shared__ void* staged[2 * SMEM_RANKS];
  bool aligned;
  long long head;
  const Table t = stage_table<T>(a.ptrs, a.n, staged, a.count, aligned, head);
  switch (a.op) {
    case OP_SUM: allreduce<T, OP_SUM, PART>(t, a, aligned, head); break;
    case OP_PROD: allreduce<T, OP_PROD, PART>(t, a, aligned, head); break;
    case OP_MAX: allreduce<T, OP_MAX, PART>(t, a, aligned, head); break;
    case OP_MIN: allreduce<T, OP_MIN, PART>(t, a, aligned, head); break;
    case OP_AVG: allreduce<T, OP_AVG, PART>(t, a, aligned, head); break;
  }
}

template <bool PART>
const void* select_instance(int dtype) {
  switch (dtype) {
    case DT_F32: return (const void*)ring_allreduce_kernel<float, PART>;
    case DT_F16: return (const void*)ring_allreduce_kernel<__half, PART>;
    case DT_BF16:
      return (const void*)ring_allreduce_kernel<__nv_bfloat16, PART>;
    case DT_I32: return (const void*)ring_allreduce_kernel<int, PART>;
    case DT_I64: return (const void*)ring_allreduce_kernel<long long, PART>;
    case DT_I8: return (const void*)ring_allreduce_kernel<signed char, PART>;
    case DT_U8:
      return (const void*)ring_allreduce_kernel<unsigned char, PART>;
    case DT_I16: return (const void*)ring_allreduce_kernel<short, PART>;
    case DT_F64: return (const void*)ring_allreduce_kernel<double, PART>;
    default: return nullptr;
  }
}

const void* select_kernel(int dtype, bool part) {
  return part ? select_instance<true>(dtype) : select_instance<false>(dtype);
}

bool known_op(int op) {
  return op == OP_SUM || op == OP_PROD || op == OP_MAX || op == OP_MIN ||
         op == OP_AVG;
}

}  // namespace

extern "C" {

// Most CTAs of `threads` threads that can be resident at once for the
// kernel of `dtype` (SMs x blocks per SM): the grid of a launch. `chunked`
// is part of the common interface; both entry points share one kernel.
int ucc_ring_allreduce_max_ctas(int chunked, int dtype, int threads,
                                int* out) {
  (void)chunked;
  const void* kern = select_kernel(dtype, false);
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

// Launch one allreduce of `count` elements per rank on `stream`, on a grid
// of `ctas` CTAs of `threads` threads, folding elements [lo, hi) of every
// rank (a team across processes launches one part in each process);
// returns cudaGetLastError() after the launch (0 on success). The
// signature is the common one of the ring sources: the kernel uses no comm
// slots, flag words or error word, and `n_chunks` and `root` follow from
// the rest or do not apply.
int ucc_ring_allreduce(int chunked, int dtype, void* const* ptrs,
                       void* comm, unsigned* flags, int* err,
                       long long count, long long blk, int n_chunks, int n,
                       int op, int root, int ctas, int threads, long long lo,
                       long long hi, cudaStream_t stream) {
  (void)chunked, (void)comm, (void)flags, (void)err, (void)n_chunks,
      (void)root;
  const void* kern = select_kernel(dtype, lo > 0 || hi < count);
  if (kern == nullptr || !known_op(op) || n < 1 || blk < 1 || lo < 0 ||
      lo > hi || hi > count)
    return (int)cudaErrorInvalidValue;
  Args a{ptrs, count, blk, lo, hi, n, op};
  void* params[] = {&a};
  cudaError_t e = cudaLaunchKernel(kern, dim3(ctas), dim3(threads), params,
                                   0, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* ucc_ring_allreduce_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
