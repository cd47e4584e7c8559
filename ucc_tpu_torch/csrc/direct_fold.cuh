// Vector machinery of the flag-free kernels of this directory
// (ring_allreduce.cu, reduce_scatter.cu, gen_fold.cu, and alltoall.cu,
// bcast.cu and allgather.cu, which only copy), which read the ranks' buffers directly and
// fold each element from its srcs in a fixed order: the launch constants,
// the pointer table as the kernels read it (staged in shared memory, with
// the launch's alignment decision), elements as raw bits, 16-byte vectors
// with cache-streaming loads and stores, and the lane-by-lane fold with the
// operands either way round.
//
// Everything here has internal linkage: each source that includes it is
// built into its own library.

#pragma once

#include "ring_common.cuh"

namespace {

// ranks whose pointers a CTA stages in shared memory; a larger team reads
// its pointer table from global memory
constexpr int SMEM_RANKS = 256;
// ranks whose loads are issued together, before their folds
constexpr int GROUP = 4;
// vectors each thread keeps in flight per rank: GROUP * UNROLL loads
constexpr int UNROLL = 2;
// threads per CTA (kernels/ring_common.py: DIRECT_THREADS)
constexpr int THREADS = 256;

// The pointer table as the kernels read it.
struct Table {
  void* const* p;
  int n;
  template <typename T>
  __device__ const T* src(int r) const {
    return static_cast<const T*>(p[r]);
  }
  template <typename T>
  __device__ T* dst(int r) const {
    return static_cast<T*>(p[n + r]);
  }
};

// an unsigned integer of B bytes: one element as raw bits, for the kernels
// that only copy (alltoall.cu, bcast.cu, allgather.cu)
template <int B> struct Raw;
template <> struct Raw<1> { using U = unsigned char; };
template <> struct Raw<2> { using U = unsigned short; };
template <> struct Raw<4> { using U = unsigned int; };
template <> struct Raw<8> { using U = unsigned long long; };

// W elements of T in one 16-byte vector
template <typename T, int W>
struct alignas(16) Pack {
  static_assert(W * sizeof(T) == 16, "a vector is 16 bytes");
  T e[W];
};

template <typename T, int W>
__device__ __forceinline__ Pack<T, W> load(const T* p) {
  Pack<T, W> v;
  *reinterpret_cast<uint4*>(&v) = __ldcs(reinterpret_cast<const uint4*>(p));
  return v;
}

template <typename T, int W>
__device__ __forceinline__ void store(T* p, const Pack<T, W>& v) {
  __stcs(reinterpret_cast<uint4*>(p), *reinterpret_cast<const uint4*>(&v));
}

// acc = acc(x, acc) lane by lane: x is the value of the rank the ring
// reaches next (local), acc the fold so far (incoming)
template <int OP, typename T, int W>
__device__ __forceinline__ void fold(Pack<T, W>& acc, const Pack<T, W>& x) {
#pragma unroll
  for (int l = 0; l < W; ++l) acc.e[l] = accumulate(OP, x.e[l], acc.e[l]);
}

// acc = acc(acc, x) lane by lane: the fold so far is the local operand
template <int OP, typename T, int W>
__device__ __forceinline__ void fold_swapped(Pack<T, W>& acc,
                                             const Pack<T, W>& x) {
#pragma unroll
  for (int l = 0; l < W; ++l) acc.e[l] = accumulate(OP, acc.e[l], x.e[l]);
}

// The launch's pointer table, the 2n pointers staged in `staged` when n <=
// SMEM_RANKS (read from global memory above), and whether every buffer may
// take the vector path: `aligned` when all 2n pointers lie at one offset
// mod 16, with `head` the elements before the first 16-byte boundary (at
// most `count`). Every thread of the CTA calls it.
template <typename T>
__device__ __forceinline__ Table stage_table(void* const* ptrs, int n,
                                             void** staged, long long count,
                                             bool& aligned, long long& head) {
  const uintptr_t mis = reinterpret_cast<uintptr_t>(ptrs[0]) & 15;
  int odd = mis % sizeof(T) != 0;
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) {
    void* p = ptrs[i];
    if (n <= SMEM_RANKS) staged[i] = p;
    odd |= (reinterpret_cast<uintptr_t>(p) & 15) != mis;
  }
  aligned = !__syncthreads_or(odd);  // also publishes `staged`
  head = min(count, (long long)((16 - mis) & 15) / (long long)sizeof(T));
  return Table{n <= SMEM_RANKS ? staged : ptrs, n};
}

// The part [lo, hi) of a walk whose 16-byte vectors start at element
// `head` and every W elements after it: the whole vectors inside it,
// [v0, v0 + vecs * W), and so the elements before and after them,
// [lo, v0) and [v0 + vecs * W, hi), which go one at a time. A launch of
// a team that spans processes walks one part (kernels/ring_common.py:
// part_bounds cuts the parts at multiples of W); [0, count) is the whole
// walk of an in-process team: v0 = head, as before parts existed.
struct Part {
  long long v0;
  long long vecs;
};

__device__ __forceinline__ Part vector_part(long long lo, long long hi,
                                            long long head, int W) {
  long long v0 = lo <= head ? head : head + (lo - head + W - 1) / W * W;
  if (v0 > hi) v0 = hi;
  return Part{v0, (hi - v0) / W};
}

}  // namespace
