// Generated device collectives whose programs are exact, as one flag-free
// pass over the ranks' srcs.
//
// Replaces, for every lowered program without a wire layer, the Pallas
// kernel ucc_tpu/dsl/lower_device.py:_build_pallas_device_program:
// ring_kernel (:525) for shift-by-one rings and gen_kernel (:595) for the
// rest. Plans with a wire layer keep the layer kernel of gen_device.cu.
//
// What it computes. kernels/gen_device.py:fold_plan runs a plan's steps
// on symbolic units on the host, phase by phase as the plain version
// gen_device_ref does (a unit is the gcd of the count and of every offset
// and length of the tables). On every registered program each unit ends,
// on every rank, as one expression over that same unit of the srcs: rings
// as a chain acc(x, acc(x, ...)), direct exchanges as acc(acc(...), x),
// halving-doubling as a balanced tree, a bcast as the root's unit. So
// element g of the result depends on element g of the srcs and on nothing
// else, and the plan's messages only carried partial folds from rank to
// rank. The host encodes each unit's tree as a short program in
// Sethi-Ullman order (the deeper operand first, a leaf folded straight
// into the other side's value):
//   LOAD        push the next leaf x (rank q's src at g)
//   FOLD_L      top = acc(x, top)
//   FOLD_R      top = acc(top, x)
//   COMB        pop the value below the top; top = acc(below, top)
//   COMB_SWAP   pop the value below the top; top = acc(top, below)
// where acc(cur, inc) is ring_common.cuh's accumulate with the receiver's
// value first, as every step of the plan applies it. A thread that runs
// the program at element g and stores the value into every dst therefore
// does the same operations on the same operands in the same order as
// gen_device_ref and the Pallas kernel: the result is bitwise theirs.
// 16-bit floats round after every operation, integers wrap, MAX and MIN
// keep the operand order that decides which NaN survives, and the library
// is built without --use_fast_math. AVG (the op of an allreduce plan)
// folds as SUM and multiplies by dtype(1/n) at the end, as the layer kernel
// does.
//
// What bounds it: bytes. An allreduce reads n*S and writes n*S bytes for S
// bytes per rank (0.3205 ms at 3.35 TB/s for 8 ranks of 64 MiB); a bcast
// reads S and writes n*S, or (n-1)*S in place. This kernel moves exactly
// that: nothing goes through comm slots.
//
// Design. A 1-D grid sized from the occupancy query walks the elements
// grid-stride; no CTA waits on another, so there are no flags, no error
// word, no grid barrier and no cooperative launch. The pointer table, the
// 16-byte cache-streaming vectors and the folds are direct_fold.cuh's,
// shared with ring_allreduce.cu and reduce_scatter.cu. Positions are
// preserved, so element g has the same index in every src and dst, and
// one check over the 2n pointers decides between the vector path and the
// scalar one for the whole launch. A thread knows the unit of its vector
// from an offset and a unit index that it advances by a fixed step, without
// a division; a vector that straddles two units (chip_smoke's counts of
// nchunks x 37 make them ragged) folds element by element, each with its
// own unit's program, as do the elements before the first 16-byte boundary
// and after the last whole vector.
// - Loads in flight: a program is warp-uniform wherever a warp's vectors
//   lie in one unit. A thread reads the next LEAVES leaf ranks of its
//   program, issues their loads together, and only then runs the steps
//   that consume them: at n = 8 a chain's eight loads are in flight at
//   once, as the allreduce keeps GROUP x UNROLL = 8 vectors in flight.
//   Programs are read through the read-only cache (__ldg).
// - The stack lives in registers: the top, and STACK - 1 slots below it
//   that are only indexed by unrolled loops compared against the stack
//   pointer, which is the same in every thread running the program. ptxas
//   must report no stack frame and no spills (chip_smoke checks).
// - In place: the only thread that reads element g of any src is the one
//   that writes element g of every dst, and it reads all its leaves before
//   it stores. A program whose only leaf is rank q's src (a bcast) skips
//   the store into dst q when that is the same buffer.
//
// Across processes of one host (tl/device_sync.py) the table mixes this
// process's pointers with CUDA IPC mappings of its peers' buffers, and
// each process folds one part [lo, hi) of the elements into all n dsts
// (kernels/ring_common.py: part_bounds, cut at multiples of the 16-byte
// vector): element g's value depends on element g of the srcs alone, so
// the union of the parts is bitwise the single launch and each element
// is read and written by one thread of one process, in place too. The
// rounds are ordered on the streams by interprocess CUDA events, not
// inside the kernel. The whole walk, [0, count), keeps an instance of its
// own (PART false), the code of a launch without parts; the part
// instances (PART true) are a library of their own, gen_fold_part.cu,
// which defines GEN_FOLD_PART and includes this file, so that nvcc builds
// the two halves of the unrolled interpreters in parallel. Across GPUs
// (ROADMAP A5) the same pointer table of peer buffers serves.

#include "direct_fold.cuh"

// the instances this library holds: the whole walk's (false) or the parts'
// (true, gen_fold_part.cu)
#ifndef GEN_FOLD_PART
#define GEN_FOLD_PART false
#endif

namespace {

// step kinds and program header of kernels/gen_device.py (S_*, FOLD_*)
constexpr int S_LOAD = 0;
constexpr int S_FOLD_L = 1;  // then S_FOLD_R = 2
constexpr int S_COMB = 3;
constexpr int HEADER = 3;  // steps, leaves, the only leaf's rank or -1
constexpr int STACK = 5;   // values a program holds at once (FOLD_STACK)

struct Args {
  void* const* ptrs;       // device array: n src pointers, then n dst
  const int* units;        // per unit: its program's offset in `code`
  const int* code;         // programs: header, leaf ranks, step kinds
  long long count;         // elements per rank
  long long unit;          // elements per unit
  long long lo, hi;        // the part of the elements this launch folds
  double alpha;            // AVG's factor dtype(1/n), exact in T
  int n;
  int op;
};

// One element, the scalar counterpart of a Pack.
template <typename T>
struct One {
  T e[1];
};

template <typename T>
__device__ __forceinline__ void load_into(One<T>& v, const T* p) {
  v.e[0] = *p;
}

template <typename T, int W>
__device__ __forceinline__ void load_into(Pack<T, W>& v, const T* p) {
  v = load<T, W>(p);
}

template <typename T>
__device__ __forceinline__ void store_from(T* p, const One<T>& v) {
  *p = v.e[0];
}

template <typename T, int W>
__device__ __forceinline__ void store_from(T* p, const Pack<T, W>& v) {
  store<T, W>(p, v);
}

template <int OP, typename T>
__device__ __forceinline__ void fold(One<T>& acc, const One<T>& x) {
  acc.e[0] = accumulate(OP, x.e[0], acc.e[0]);
}

template <int OP, typename T>
__device__ __forceinline__ void fold_swapped(One<T>& acc, const One<T>& x) {
  acc.e[0] = accumulate(OP, acc.e[0], x.e[0]);
}

// top = acc(below, top) for COMB, acc(top, below) for COMB_SWAP, the value
// below the top popped: slot sp - 1, chosen by an unrolled comparison so
// that the slots stay in registers.
template <int OP, typename V>
__device__ __forceinline__ void combine(V& top, V (&below)[STACK - 1],
                                        int& sp, int kind) {
  --sp;
#pragma unroll
  for (int j = 0; j < STACK - 1; ++j)
    if (j == sp) {
      if (kind == S_COMB)
        fold<OP>(top, below[j]);
      else
        fold_swapped<OP>(top, below[j]);
    }
}

// The value of program `prog` at element e of its leaves' srcs.
template <typename T, int OP, typename V>
__device__ __forceinline__ V evaluate(const Table& t, const int* prog,
                                      long long e) {
  // leaf loads a thread issues together: PR 8's GROUP x UNROLL vectors,
  // or GROUP for 1-byte types, whose 16 lanes take 16 registers a vector
  // once unpacked (the allreduce's int8 instance holds 10 in 240)
  constexpr int LEAVES = sizeof(T) == 1 ? GROUP : GROUP * UNROLL;
  const int steps = __ldg(prog);
  const int leaves = __ldg(prog + 1);
  const int* leaf = prog + HEADER;
  const int* kind = leaf + leaves;
  V top;
  V below[STACK - 1];
  int sp = 0;  // values below the top
  int k = 0;   // the next step
  for (int base = 0; base < leaves; base += LEAVES) {
    V x[LEAVES];
#pragma unroll
    for (int i = 0; i < LEAVES; ++i)
      if (base + i < leaves)
        load_into(x[i], t.src<T>(__ldg(leaf + base + i)) + e);
#pragma unroll
    for (int i = 0; i < LEAVES; ++i) {
      if (base + i >= leaves) break;
      int s = __ldg(kind + k++);
      while (s >= S_COMB) {  // the combines before the next leaf's step
        combine<OP>(top, below, sp, s);
        s = __ldg(kind + k++);
      }
      if (s == S_LOAD) {
        if (k > 1) {  // not the program's first step: push the top
#pragma unroll
          for (int j = 0; j < STACK - 1; ++j)
            if (j == sp) below[j] = top;
          ++sp;
        }
        top = x[i];
      } else if (s == S_FOLD_L) {
        fold<OP>(top, x[i]);
      } else {  // S_FOLD_R
        fold_swapped<OP>(top, x[i]);
      }
    }
  }
  while (k < steps) combine<OP>(top, below, sp, __ldg(kind + k++));
  return top;
}

// Unit q's value at element e, times AVG's factor, into every dst.
template <typename T, int OP, typename V>
__device__ __forceinline__ void fold_and_store(const Table& t, const Args& a,
                                               T inv, long long q,
                                               long long e) {
  const int* prog = a.code + __ldg(a.units + q);
  V v = evaluate<T, OP, V>(t, prog, e);
  if (OP == OP_AVG) {
#pragma unroll
    for (int l = 0; l < (int)(sizeof(v.e) / sizeof(T)); ++l)
      v.e[l] = Elem<T>::mul(v.e[l], inv);
  }
  const int lone = __ldg(prog + 2);
  for (int r = 0; r < t.n; ++r)
    if (r != lone || t.dst<T>(r) != t.src<T>(r))
      store_from(t.dst<T>(r) + e, v);
}

// One element: the path of the head, the tail, misaligned launches and
// each element of a vector that straddles two units.
template <typename T, int OP>
__device__ __noinline__ void fold_element(Table t, Args a, T inv,
                                          long long q, long long g) {
  fold_and_store<T, OP, One<T>>(t, a, inv, q, g);
}

// Elements lo .. lo+count-1 one at a time, grid-stride, each thread
// advancing its element's offset in its unit and the unit's index without
// a division.
template <typename T, int OP>
__device__ void sweep_elements(const Table& t, const Args& a, T inv,
                               long long lo, long long count) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (first >= count) return;
  long long q = (lo + first) / a.unit;
  long long off = lo + first - q * a.unit;
  const long long step_q = stride / a.unit;
  const long long step_off = stride - step_q * a.unit;
  for (long long g = lo + first; g < lo + count; g += stride) {
    fold_element<T, OP>(t, a, inv, q, g);
    off += step_off;
    q += step_q;
    if (off >= a.unit) {
      off -= a.unit;
      ++q;
    }
  }
}

// Vectors 0 .. vecs-1 of W elements each, vector u at element lo + u * W
// of every rank, grid-stride.
template <typename T, int OP, int W>
__device__ void sweep(const Table& t, const Args& a, T inv, long long lo,
                      long long vecs) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (first >= vecs) return;
  // the vector's first element: its offset in its unit and the unit
  long long q = (lo + first * W) / a.unit;
  long long off = lo + first * W - q * a.unit;
  const long long step_q = stride * W / a.unit;
  const long long step_off = stride * W - step_q * a.unit;
  for (long long u = first; u < vecs; u += stride) {
    const long long e = lo + u * W;
    if (off + W <= a.unit) {
      fold_and_store<T, OP, Pack<T, W>>(t, a, inv, q, e);
    } else {
      long long o = off, qq = q;
      for (int l = 0; l < W; ++l) {
        fold_element<T, OP>(t, a, inv, qq, e + l);
        if (++o == a.unit) {
          o = 0;
          ++qq;
        }
      }
    }
    off += step_off;
    q += step_q;
    if (off >= a.unit) {
      off -= a.unit;
      ++q;
    }
  }
}

// Elements [lo, hi) of every rank: 16-byte vectors where the pointers
// allow, single elements at the head, at the tail and everywhere when they
// do not. PART: a launch of one part of the elements (a team across
// processes); the whole walk, [0, count) (PART false), keeps the code of a
// launch without parts.
template <typename T, int OP, bool PART>
__device__ void fold_all(const Table& t, const Args& a, T inv, bool aligned,
                         long long head) {
  constexpr int W = 16 / sizeof(T);
  if (!aligned) {
    sweep_elements<T, OP>(t, a, inv, a.lo, a.hi - a.lo);
    return;
  }
  if (!PART) {
    const long long vecs = (a.count - head) / W;
    const long long tail = head + vecs * W;
    sweep<T, OP, W>(t, a, inv, head, vecs);
    sweep_elements<T, OP>(t, a, inv, 0, head);
    sweep_elements<T, OP>(t, a, inv, tail, a.count - tail);
    return;
  }
  const Part p = vector_part(a.lo, a.hi, head, W);
  const long long tail = p.v0 + p.vecs * W;
  sweep<T, OP, W>(t, a, inv, p.v0, p.vecs);
  sweep_elements<T, OP>(t, a, inv, a.lo, p.v0 - a.lo);
  sweep_elements<T, OP>(t, a, inv, tail, a.hi - tail);
}

template <typename T, bool PART>
__global__ void __launch_bounds__(THREADS) gen_fold_kernel(Args a) {
  __shared__ void* staged[2 * SMEM_RANKS];
  bool aligned;
  long long head;
  const Table t = stage_table<T>(a.ptrs, a.n, staged, a.count, aligned, head);
  const T inv = from_double<T>(a.alpha);
  switch (a.op) {
    case OP_SUM: fold_all<T, OP_SUM, PART>(t, a, inv, aligned, head); break;
    case OP_PROD: fold_all<T, OP_PROD, PART>(t, a, inv, aligned, head); break;
    case OP_MAX: fold_all<T, OP_MAX, PART>(t, a, inv, aligned, head); break;
    case OP_MIN: fold_all<T, OP_MIN, PART>(t, a, inv, aligned, head); break;
    case OP_AVG: fold_all<T, OP_AVG, PART>(t, a, inv, aligned, head); break;
  }
}

template <bool PART>
const void* select_instance(int dtype) {
  switch (dtype) {
    case DT_F32: return (const void*)gen_fold_kernel<float, PART>;
    case DT_F16: return (const void*)gen_fold_kernel<__half, PART>;
    case DT_BF16: return (const void*)gen_fold_kernel<__nv_bfloat16, PART>;
    case DT_I32: return (const void*)gen_fold_kernel<int, PART>;
    case DT_I64: return (const void*)gen_fold_kernel<long long, PART>;
    case DT_I8: return (const void*)gen_fold_kernel<signed char, PART>;
    case DT_U8: return (const void*)gen_fold_kernel<unsigned char, PART>;
    case DT_I16: return (const void*)gen_fold_kernel<short, PART>;
    case DT_F64: return (const void*)gen_fold_kernel<double, PART>;
    default: return nullptr;
  }
}

const void* select_kernel(int dtype) {
  return select_instance<GEN_FOLD_PART>(dtype);
}

bool known_op(int op) {
  return op == OP_SUM || op == OP_PROD || op == OP_MAX || op == OP_MIN ||
         op == OP_AVG;
}

}  // namespace

extern "C" {

// Most CTAs of `threads` threads that can be resident at once for the
// kernel of `dtype` (SMs x blocks per SM): the grid of a launch. `kernel`
// is part of the common interface; the source has one kernel.
int ucc_gen_fold_max_ctas(int kernel, int dtype, int threads, int* out) {
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

// Launch one exact generated collective of `count` elements per rank on
// `stream`, on a grid of `ctas` CTAs of `threads` threads, folding elements
// [lo, hi) of every rank (a team across processes launches one part in
// each process): `units` and `code` are the fold plan's tables on the
// device, `op` the fold (SUM for a bcast), `alpha` AVG's factor. This
// library takes the whole walk or, built as gen_fold_part.cu, a part of
// it, and refuses the other. Returns cudaGetLastError() after the launch
// (0 on success).
int ucc_gen_fold(int dtype, void* const* ptrs, const int* units,
                 const int* code, long long count, long long unit, int n,
                 int op, double alpha, int ctas, int threads, long long lo,
                 long long hi, cudaStream_t stream) {
  const void* kern = select_kernel(dtype);
  if (kern == nullptr || !known_op(op) || n < 1 || unit < 1 ||
      count % unit != 0 || lo < 0 || lo > hi || hi > count ||
      (lo > 0 || hi < count) != GEN_FOLD_PART)
    return (int)cudaErrorInvalidValue;
  Args a{ptrs, units, code, count, unit, lo, hi, alpha, n, op};
  void* params[] = {&a};
  cudaError_t e = cudaLaunchKernel(kern, dim3(ctas), dim3(threads), params,
                                   0, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* ucc_gen_fold_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
