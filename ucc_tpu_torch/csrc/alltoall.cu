// Alltoall over the n ranks of one GPU, as one flag-free pass over the
// ranks' pairs.
//
// Replaces the Pallas kernels of the JAX package:
//   ring_alltoall_pass     <- ucc_tpu/tl/ring_dma.py:_alltoall_kernel with
//                             _all_rank_barrier (build_alltoall_program);
//   ring_alltoall_chunked  <- ucc_tpu/tl/ring_dma.py:_hbm_alltoall_kernel
//                             (build_hbm_alltoall_program).
// Both entry points launch the one kernel below with the same arguments:
// an alltoall only copies, so its result depends on no chunk size.
//
// What it computes. Rank r's src and dst are n blocks of blk elements, and
//   dst_p[r * blk + i] = src_r[p * blk + i]   for every r, p and i < blk.
// Every element moves as raw bits, in 16-byte uint4 vectors (the load and
// store of direct_fold.cuh) or as an unsigned integer of its width: no
// float register and no arithmetic touches it, so NaN payloads and -0.0
// arrive as they were sent. This is the plain version's result
// (ucc_tpu_torch/kernels/ring_bcast_a2a.py: ring_alltoall_ref) and the
// Pallas kernels' in interpret mode, bit for bit.
//
// Work units. The n diagonal blocks: src_r's block r to dst_r's block r
// (in place, src_r = dst_r, a no-op that is skipped). The n(n-1)/2 pairs
// {r, q}, each with one owner (ring_bcast_a2a.py: owns_pair): r owns
// {r, r+s} when 2s < n, and, when 2s = n, the lower rank does. The thread
// that moves element e of pair {r, q} reads src_r[q*blk+e] and
// src_q[r*blk+e] before it writes dst_q[r*blk+e] or dst_r[q*blk+e]. Every
// location a launch touches then has exactly one owner thread, which reads
// it (where it reads it) before it writes it, so in place (src = dst) is
// safe with no staging, and a launch needs no barrier inside it.
//
// Grid. One ordinary launch of a 1-D grid sized from the occupancy query:
// no flags, no error word, no spin, no cooperative launch and no
// co-residency rule, so any n up to MAX_RANKS runs. Each unit's block is
// cut into slots: slot 0 is the unit's head (the elements before its first
// 16-byte boundary) and slot j >= 1 the j-th W-element vector after it
// (W = 16 / sizeof(T)), the last one ragged; every unit has
// S = 1 + ceil(blk / W) slots, those past its end empty, in tiles of
// 32 * depth slots. The warps of the grid walk the (unit, tile) items
// warp-stride, unit-major, each advancing its (unit, tile) without a
// division: a warp decodes its unit once per tile, and lane l takes the
// tile's slots l, l + 32, ..., so each load and store of a warp is 512
// contiguous bytes. The depth is UNROLL, or less when the launch has fewer
// slots than 32 * UNROLL per warp, so that a small alltoall still gives
// every warp a tile. Every warp so takes diagonals and pairs in the
// proportion the launch has them: the rows of the ring kernel this
// replaces were uneven (at n = 8 ranks 0-3 own four pairs, 4-7 three),
// and here no rank's share sets the pace. A lane issues its UNROLL slots'
// loads (two vectors for a pair, one for a diagonal) before any of their
// stores.
//
// Alignment is decided per unit. A pair's four addresses (src_r + q*blk,
// src_q + r*blk, dst_q + r*blk, dst_r + q*blk) and a diagonal's two change
// their offset mod 16 with the block whenever blk * sizeof(T) is no
// multiple of 16. A unit whose addresses share one offset mod 16 moves its
// head and its ragged last slot element by element and the rest as
// vectors; any other unit moves every slot element by element.
//
// What bounds it: bytes. An alltoall must read every src once and write
// every dst once, 2 * n * S bytes for S bytes per rank (0.3205 ms at
// 3.35 TB/s for 8 ranks of 64 MiB); the pair exchange moves exactly that.
// The workspace (comm slots, flags, error word) is not used.
//
// Across processes (ROADMAP A5) the same pointer table of CUDA IPC peer
// pointers is the direct pairwise alltoall, with two all-rank barriers
// around the pass, which inside one process the stream provides: one on
// entry (every rank's src is ready before any pair reads it) and one on
// exit (no peer still reads my src or writes my dst when my launch ends).

#include "direct_fold.cuh"

namespace {

// the most ranks a launch takes: n(n+1)/2 units and the grid stride stay
// inside the kernel's 32-bit unit index (kernels/ring_bcast_a2a.py:
// A2A_MAX_RANKS)
constexpr int MAX_RANKS = 32768;
// slots a lane takes per tile at most, their loads issued before any
// store. On the H100, 8 deep at one CTA per SM (the registers they take)
// moved 8 x 64 MiB faster than 2 or 4 deep at 2-4 CTAs per SM
// (tools/alltoall_depth.py).
constexpr int A2A_UNROLL = 8;
constexpr int WARP = 32;

struct Args {
  void* const* ptrs;   // device array: n src pointers, then n dst pointers
  long long blk;       // elements of one block; a src or dst holds n
  int n;
};

// The ranks of unit u, in the order of ring_bcast_a2a.py's alltoall_units:
// a diagonal (u < n: r = q = u); else, with m = (n-1)/2, for s = 1 .. m
// rank r's pair with r+s at u = n + r*m + s-1, then, for even n, rank
// r < n/2's pair with r + n/2 at u = n + n*m + r. r owns the pair.
__device__ __forceinline__ void unit_ranks(int u, int n, int m, int& r,
                                           int& q) {
  if (u < n) {
    r = q = u;
    return;
  }
  const int k = u - n;
  if (k < n * m) {
    r = k / m;
    q = r + (k - r * m) + 1;
    if (q >= n) q -= n;
  } else {
    r = k - n * m;
    q = r + n / 2;
  }
}

// One unit's addresses at the start of its blocks, a -> c and, for a pair,
// b -> d, and how its slots fall: the same for every lane of a warp.
template <typename U>
struct Unit {
  const U* a;
  const U* b;
  U* c;
  U* d;
  long long head;  // elements before the first 16-byte boundary (slot 0)
  bool pair;
  bool aligned;    // every address at one offset mod 16: vectors
  bool live;       // false for a diagonal in place: nothing to move
};

template <typename U>
__device__ __forceinline__ Unit<U> locate(const Table& t, long long blk,
                                          int n, int m, int u) {
  int r, q;
  unit_ranks(u, n, m, r, q);
  Unit<U> un;
  un.pair = r != q;
  un.a = t.src<U>(r) + q * blk;
  un.c = t.dst<U>(q) + r * blk;
  un.b = t.src<U>(q) + r * blk;
  un.d = t.dst<U>(r) + q * blk;
  const uintptr_t pa = reinterpret_cast<uintptr_t>(un.a);
  uintptr_t diff = pa ^ reinterpret_cast<uintptr_t>(un.c);
  if (un.pair)
    diff |= (pa ^ reinterpret_cast<uintptr_t>(un.b)) |
            (pa ^ reinterpret_cast<uintptr_t>(un.d));
  const uintptr_t mis = pa & 15;
  un.aligned = (diff & 15) == 0 && mis % sizeof(U) == 0;
  un.head = un.aligned ? min(blk, (long long)((16 - mis) & 15) /
                                      (long long)sizeof(U))
                       : 0;
  un.live = un.pair || un.a != un.c;
  return un;
}

// Elements [lo, lo + len) of a unit off the vector path, one at a time,
// each pair's two reads before its two writes.
template <typename U>
__device__ __noinline__ void move_elements(Unit<U> un, long long lo,
                                           int len) {
  for (long long e = lo; e < lo + len; ++e) {
    const U x = un.a[e];
    if (un.pair) {
      const U y = un.b[e];
      un.c[e] = x;
      un.d[e] = y;
    } else {
      un.c[e] = x;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) alltoall_kernel(Args a) {
  using U = typename Raw<sizeof(T)>::U;
  constexpr int W = 16 / sizeof(U);
  __shared__ void* staged[2 * SMEM_RANKS];
  const int n = a.n;
  int moved = 0;  // some rank's src is not its dst
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) {
    void* p = a.ptrs[i];
    if (n <= SMEM_RANKS) staged[i] = p;
    if (i < n) moved |= p != a.ptrs[n + i];
  }
  // in place on every rank, no diagonal has anything to move
  const int first = __syncthreads_or(moved) ? 0 : n;  // publishes `staged`
  const Table t{n <= SMEM_RANKS ? staged : a.ptrs, n};
  const int m = (n - 1) / 2;
  const int units = n * (n + 1) / 2 - first;
  const long long blk = a.blk;
  const long long slots = 1 + (blk + W - 1) / W;
  const long long warps = (long long)gridDim.x * (blockDim.x / WARP);
  // slots a lane takes per tile, so that the tiles outnumber the warps
  const int depth = (int)max(
      1ll, min((long long)A2A_UNROLL, units * slots / (WARP * warps)));
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
    const Unit<U> un = locate<U>(t, blk, n, m, first + u);
    if (un.live) {
      long long lo[A2A_UNROLL];
      int len[A2A_UNROLL];
      bool vec[A2A_UNROLL];
      Pack<U, W> x[A2A_UNROLL][2];
#pragma unroll
      for (int k = 0; k < A2A_UNROLL; ++k) {
        const long long j = tile * tile_slots + k * WARP + lane;
        lo[k] = j == 0 ? 0 : un.head + (j - 1) * W;
        const long long hi = j == 0 ? un.head : min(blk, un.head + j * W);
        len[k] = k < depth && hi > lo[k] ? (int)(hi - lo[k]) : 0;
        vec[k] = un.aligned && j > 0 && len[k] == W;
        if (vec[k]) {
          x[k][0] = load<U, W>(un.a + lo[k]);
          if (un.pair) x[k][1] = load<U, W>(un.b + lo[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < A2A_UNROLL; ++k)
        if (vec[k]) {
          store<U, W>(un.c + lo[k], x[k][0]);
          if (un.pair) store<U, W>(un.d + lo[k], x[k][1]);
        }
#pragma unroll
      for (int k = 0; k < A2A_UNROLL; ++k)
        if (len[k] && !vec[k]) move_elements<U>(un, lo[k], len[k]);
    }
    tile += step_t;
    if (tile >= tiles) {
      tile -= tiles;
      ++u;
    }
  }
}

const void* select_kernel(int dtype) {
  switch (dtype) {
    case DT_F32: return (const void*)alltoall_kernel<float>;
    case DT_F16: return (const void*)alltoall_kernel<__half>;
    case DT_BF16: return (const void*)alltoall_kernel<__nv_bfloat16>;
    case DT_I32: return (const void*)alltoall_kernel<int>;
    case DT_I64: return (const void*)alltoall_kernel<long long>;
    case DT_I8: return (const void*)alltoall_kernel<signed char>;
    case DT_U8: return (const void*)alltoall_kernel<unsigned char>;
    case DT_I16: return (const void*)alltoall_kernel<short>;
    case DT_F64: return (const void*)alltoall_kernel<double>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Most CTAs of `threads` threads that can be resident at once for the
// kernel of `dtype` (SMs x blocks per SM): the grid's size. `kernel` is
// part of the common interface; both entry points share one kernel.
int ucc_alltoall_max_ctas(int kernel, int dtype, int threads, int* out) {
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

// Launch one alltoall of n blocks of `blk` elements per rank on `stream`,
// on a grid of `ctas` CTAs of `threads` threads; returns
// cudaGetLastError() after the launch (0 on success). The signature is the
// common one of the ring sources: the kernel uses no comm slots, flag
// words, error word or op, and `cblk`, `n_chunks` and `root` do not apply.
int ucc_alltoall(int kernel, int dtype, void* const* ptrs, void* comm,
                 unsigned* flags, int* err, long long blk, long long cblk,
                 int n_chunks, int n, int op, int root, int ctas, int threads,
                 cudaStream_t stream) {
  (void)kernel, (void)comm, (void)flags, (void)err, (void)cblk,
      (void)n_chunks, (void)op, (void)root;
  const void* kern = select_kernel(dtype);
  if (kern == nullptr || n < 1 || n > MAX_RANKS || blk < 1 || ctas < 1)
    return (int)cudaErrorInvalidValue;
  Args a{ptrs, blk, n};
  void* params[] = {&a};
  cudaError_t e = cudaLaunchKernel(kern, dim3(ctas), dim3(threads), params,
                                   0, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* ucc_alltoall_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
