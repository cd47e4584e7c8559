// Vector machinery of the flag-free kernels of this directory
// (ring_allreduce.cu, reduce_scatter.cu), which read the ranks' buffers
// directly and fold each element from its n srcs in the ring's order: the
// launch constants, the pointer table as the kernels read it, 16-byte
// vectors with cache-streaming loads and stores, and the lane-by-lane fold.
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

}  // namespace
