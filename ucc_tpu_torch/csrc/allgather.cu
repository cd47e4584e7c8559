// Allgather over the n ranks of one GPU, as one flag-free pass from the
// ranks' srcs.
//
// Replaces the Pallas kernels of the JAX package:
//   ring_allgather_pass    <- ucc_tpu/tl/ring_dma.py:_ring_kernel in
//                             allgather mode (build_ring_program);
//   ring_allgather_chunked <- ucc_tpu/tl/ring_dma.py:_hbm_allgather_kernel.
// Both entry points launch the one kernel below with the same arguments:
// an allgather only copies, so its result depends on no chunk size.
//
// What it computes. For every rank r, every source rank b and every
// i < count,
//   dst_r[b * count + i] = src_b[i];
// rank b's own block is skipped when it is its src (dst_b + b * count ==
// src_b, UCC's in-place layout): then the only write that could touch what
// another thread reads is never issued, and one pass needs no barrier.
// Every element moves as raw bits (direct_fold.cuh's Raw<B>), in 16-byte
// uint4 vectors or as an unsigned integer of its width: no float register
// touches it, so NaN payloads, infinities and -0.0 arrive as they left.
// This is torch.cat(srcs) on every rank, and the plain version
// (ucc_tpu_torch/kernels/ring_rs_ag.py: ring_allgather_ref) and the Pallas
// kernels in interpret mode, bit for bit. A copy has no arithmetic, so the
// kernel is built once per element width (1, 2, 4 and 8 bytes), not once
// per dtype.
//
// Units. The allgather is n bcasts, one from each rank: unit b is "src_b
// into block b of every dst". One ordinary launch of a 1-D grid sized from
// the occupancy query (kernels/ring_common.py: launch_ctas over the n *
// count elements of the n units): no flags, no error word, no spin, no
// cooperative launch and no co-residency rule, so any n runs. As in
// alltoall.cu, each unit is cut into slots: slot 0 is the unit's head (the
// elements before its src's first 16-byte boundary) and slot j >= 1 the
// j-th W-element vector after it (W = 16 / B), the last one ragged; every
// unit has S = 1 + ceil(count / W) slots, those past its end empty, in
// tiles of 32 * depth slots. The warps of the grid walk the (unit, tile)
// items warp-stride, unit-major, each advancing its (unit, tile) without a
// division: a warp decodes its unit once per tile, and lane l takes the
// tile's slots l, l + 32, ..., so each warp store is 512 contiguous bytes
// of one dst. A lane issues the loads of its slots of src_b first, then
// stores each of them into every dst, dst by dst, as bcast.cu does. The
// depth is AG_UNROLL, or less when the launch has fewer slots than
// 32 * AG_UNROLL per warp, so that a small allgather still gives every
// warp a tile.
//
// Alignment is decided per unit, cheaply. Block b of dst_r lies at
// dst_r + b * count * B, whose offset mod 16 changes with b when
// count * B is no multiple of 16. Once per CTA the n dsts are checked to
// share one offset mod 16 (O(n)); then unit b takes the vector path iff
// (src_b - dst_0 - b * count * B) mod 16 == 0 and src_b's own offset mod
// 16 is a multiple of B (O(1) per unit). On that path the head and the
// ragged last slot go element by element and the rest as vectors; a unit
// off it goes element by element throughout. One launch may hold units on
// both paths (odd n, count = 1001 f32). A CTA stages the 2n pointers in
// shared memory up to SMEM_RANKS ranks and reads them from global memory
// above that.
//
// What bounds it: bytes. An allgather must read every src once and write
// every dst once, n * S + n * (n * S) bytes for S bytes per rank (0.1803
// ms at 3.35 TB/s for 8 ranks of 8 MiB); the kernel moves exactly that,
// n stores for every load: nothing is read back from a dst and nothing
// waits on another CTA. The workspace (comm slots, flags, error word) is
// not used.
//
// Across processes of one host (tl/device_sync.py) the pointer table
// mixes this process's pointers with CUDA IPC mappings of its peers'
// buffers, and each process moves one part [lo, hi) of the n * count
// elements (unit b's element e being b * count + e) into every dst;
// interprocess CUDA events on the streams, not barriers inside the kernel,
// order the parts after every rank's inputs and before any rank's request
// completes.

#include "direct_fold.cuh"

namespace {

// slots a lane takes per tile at most, their loads issued before any
// store (tools/allgather_depth.py times other depths)
constexpr int AG_UNROLL = 8;
constexpr int WARP = 32;

struct Args {
  void* const* ptrs;   // device array: n src pointers, then n dst pointers
  long long count;     // elements per rank: a src holds count, a dst n
  long long lo, hi;    // the part of the n * count copied elements (unit
                       // b's element e is b * count + e) this launch moves
  int n;
  int u0, units;       // the part's units, b = u0 .. u0 + units - 1
};

// Unit b: src_b, the block's first element in every dst, and how its
// slots fall; the same for every lane of a warp.
template <typename U>
struct Unit {
  const U* src;
  long long at;    // b * count
  long long head;  // elements before the first 16-byte boundary (slot 0)
  int skip;        // b when dst_b's block b is src_b (in place), else -1
  bool aligned;    // src_b and block b of every dst at one offset mod 16
};

template <typename U>
__device__ __forceinline__ Unit<U> locate(void* const* ptrs, int n,
                                          long long count, bool dsts_even,
                                          int b) {
  Unit<U> un;
  un.src = static_cast<const U*>(ptrs[b]);
  un.at = (long long)b * count;
  un.skip = static_cast<const U*>(ptrs[n + b]) + un.at == un.src ? b : -1;
  const uintptr_t s = reinterpret_cast<uintptr_t>(un.src);
  const uintptr_t d = reinterpret_cast<uintptr_t>(ptrs[n]) +
                      (uintptr_t)un.at * sizeof(U);
  const uintptr_t mis = s & 15;
  un.aligned = dsts_even && ((s - d) & 15) == 0 && mis % sizeof(U) == 0;
  un.head = un.aligned ? min(count, (long long)((16 - mis) & 15) /
                                        (long long)sizeof(U))
                       : 0;
  return un;
}

// Elements [lo, lo + len) of a unit off the vector path, one at a time:
// each element's load, then its stores into every dst.
template <typename U>
__device__ __noinline__ void copy_elements(void* const* dst, int n,
                                           Unit<U> un, long long lo,
                                           int len) {
  for (long long e = lo; e < lo + len; ++e) {
    const U x = un.src[e];
    for (int r = 0; r < n; ++r)
      if (r != un.skip) static_cast<U*>(dst[r])[un.at + e] = x;
  }
}

// The allgather of elements of B bytes; PART: a launch of one part of the
// walk (a team across processes), whose units are clipped to it. The
// whole walk (PART false) keeps the code of a launch without parts.
template <int B, bool PART>
__global__ void __launch_bounds__(THREADS) allgather_kernel(Args a) {
  using U = typename Raw<B>::U;
  constexpr int W = 16 / B;
  __shared__ void* staged[2 * SMEM_RANKS];
  const int n = a.n;
  const uintptr_t mis = reinterpret_cast<uintptr_t>(a.ptrs[n]) & 15;
  int odd = 0;  // some dst at another offset mod 16 than dst_0
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) {
    void* p = a.ptrs[i];
    if (n <= SMEM_RANKS) staged[i] = p;
    if (i >= n) odd |= (reinterpret_cast<uintptr_t>(p) & 15) != mis;
  }
  const bool dsts_even = !__syncthreads_or(odd);  // publishes `staged`
  void* const* ptrs = n <= SMEM_RANKS ? staged : a.ptrs;
  void* const* dst = ptrs + n;
  const long long count = a.count;
  const int u0 = PART ? a.u0 : 0;
  const int units = PART ? a.units : n;
  const long long slots = 1 + (count + W - 1) / W;
  const long long warps = (long long)gridDim.x * (blockDim.x / WARP);
  // slots a lane takes per tile, so that the tiles outnumber the warps
  const int depth = (int)max(
      1ll, min((long long)AG_UNROLL, units * slots / (WARP * warps)));
  const long long tile_slots = (long long)WARP * depth;
  const long long tiles = (slots + tile_slots - 1) / tile_slots;  // a unit's
  const int step_u = (int)(warps / tiles);
  const long long step_t = warps % tiles;
  const long long w =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / WARP;
  const int lane = threadIdx.x % WARP;
  int u = (int)(w / tiles);
  long long tile = w % tiles;
  for (; u < units; u += step_u) {
    const Unit<U> un = locate<U>(ptrs, n, count, dsts_even, u0 + u);
    // the unit's elements in the part; a slot cut by the part's edge goes
    // element by element
    const long long elo = PART && a.lo > un.at ? a.lo - un.at : 0;
    const long long ehi =
        PART && a.hi - un.at < count ? a.hi - un.at : count;
    if (n > 1 || un.skip < 0) {  // else one rank in place: nothing to move
      long long lo[AG_UNROLL];
      int len[AG_UNROLL];
      bool vec[AG_UNROLL];
      Pack<U, W> x[AG_UNROLL];
#pragma unroll
      for (int k = 0; k < AG_UNROLL; ++k) {
        const long long j = tile * tile_slots + k * WARP + lane;
        lo[k] = j == 0 ? 0 : un.head + (j - 1) * W;
        long long hi = j == 0 ? un.head : min(count, un.head + j * W);
        if (PART) {
          lo[k] = max(elo, lo[k]);
          hi = min(ehi, hi);
        }
        len[k] = k < depth && hi > lo[k] ? (int)(hi - lo[k]) : 0;
        vec[k] = un.aligned && j > 0 && len[k] == W;
        if (vec[k]) x[k] = load<U, W>(un.src + lo[k]);
      }
      for (int r = 0; r < n; ++r) {
        if (r == un.skip) continue;
        U* d = static_cast<U*>(dst[r]) + un.at;
#pragma unroll
        for (int k = 0; k < AG_UNROLL; ++k)
          if (vec[k]) store<U, W>(d + lo[k], x[k]);
      }
#pragma unroll
      for (int k = 0; k < AG_UNROLL; ++k)
        if (len[k] && !vec[k]) copy_elements<U>(dst, n, un, lo[k], len[k]);
    }
    tile += step_t;
    if (tile >= tiles) {
      tile -= tiles;
      ++u;
    }
  }
}

template <bool PART>
const void* select_instance(int dtype) {
  switch (dtype) {
    case DT_I8:
    case DT_U8: return (const void*)allgather_kernel<1, PART>;
    case DT_F16:
    case DT_BF16:
    case DT_I16: return (const void*)allgather_kernel<2, PART>;
    case DT_F32:
    case DT_I32: return (const void*)allgather_kernel<4, PART>;
    case DT_I64:
    case DT_F64: return (const void*)allgather_kernel<8, PART>;
    default: return nullptr;
  }
}

const void* select_kernel(int dtype, bool part) {
  return part ? select_instance<true>(dtype) : select_instance<false>(dtype);
}

}  // namespace

extern "C" {

// Most CTAs of `threads` threads that can be resident at once for the
// kernel of `dtype`'s width (SMs x blocks per SM): the grid's size.
// `kernel` is part of the common interface; both entry points share one
// kernel.
int ucc_allgather_max_ctas(int kernel, int dtype, int threads, int* out) {
  (void)kernel;
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

// Launch one allgather of `count` elements per rank on `stream`, on a grid
// of `ctas` CTAs of `threads` threads, moving elements [lo, hi) of the
// n * count (a team across processes launches one part in each process);
// returns cudaGetLastError() after the launch (0 on success). The
// signature is the common one of the ring sources: the kernel uses no comm
// slots, flag words, error word or op, and `cblk`, `n_chunks` and `root`
// do not apply.
int ucc_allgather(int kernel, int dtype, void* const* ptrs, void* comm,
                  unsigned* flags, int* err, long long count, long long cblk,
                  int n_chunks, int n, int op, int root, int ctas,
                  int threads, long long lo, long long hi,
                  cudaStream_t stream) {
  (void)kernel, (void)comm, (void)flags, (void)err, (void)cblk,
      (void)n_chunks, (void)op, (void)root;
  const void* kern = select_kernel(dtype, lo > 0 || hi < n * count);
  if (kern == nullptr || n < 1 || count < 1 || ctas < 1 || lo < 0 ||
      lo >= hi || hi > n * count)
    return (int)cudaErrorInvalidValue;
  // the part's units, divided out here rather than in every thread
  Args a{ptrs, count, lo, hi, n, (int)(lo / count),
         (int)((hi - 1) / count - lo / count + 1)};
  void* params[] = {&a};
  cudaError_t e = cudaLaunchKernel(kern, dim3(ctas), dim3(threads), params,
                                   0, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* ucc_allgather_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
