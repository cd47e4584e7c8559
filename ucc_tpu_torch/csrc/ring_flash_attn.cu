// Ring flash-attention forward of an n-rank sequence-parallel ring, as one
// kernel launch.
//
// Replaces ucc_tpu/fused_attention.py:_kernel (the Pallas kernel that
// fused_attention._build compiles). Rank `me` holds q (h, s, d) and k, v
// (h_kv, s, d) of T, its block of s consecutive sequence positions, and
// gets o (h, s, d) of T: exact softmax attention of its queries against
// the whole sequence. The arithmetic is the Pallas kernel's, step for step:
// - q is cast to float and multiplied by `scale` before the dot (the
//   tensor-core route below scales the dot instead);
// - exp(x) is computed as exp2(x·log2 e), with log2 e folded into `scale`
//   (the float route's exp2f, the tensor-core route's ex2.approx);
// - query head j reads K/V head j / (h / h_kv) (GQA, consecutive groups);
// - for t = 0..n-1 the K/V block of rank src = (me - t) mod n is folded in:
//   S = q·Kᵀ in float; under causal, S = -inf where the global query
//   position me·s + i is earlier than the key position src·s + j;
//   m_new = max(m, rowmax S); safe_m = isfinite(m_new) ? m_new : 0;
//   p = isfinite(S) ? exp(S - safe_m) : 0;
//   corr = isfinite(m) ? exp(m - safe_m) : 0;
//   l = l·corr + rowsum p; acc = acc·corr + p·V; m = m_new;
// - o = acc / (l == 0 ? 1 : l), rounded to T to nearest even.
// The kernels fold a block in key tiles (kF32BK, kTcBK rows), so one block
// is several such updates; the result differs from one update per block
// only by float rounding.
//
// Pull, not push. On the TPU a chip reads only its own VMEM, so K/V
// rotate: a remote DMA per step into 2-slot parity buffers, throttled by a
// consumer ack. Here the n ranks are buffers on one card and K/V are
// read-only for the whole call, so at step t a CTA of rank `me` reads rank
// src's K/V straight through the pointer table: the same blocks in the same
// order as the rotation delivers them, with no slots, flags, spins or
// cooperative launch, so nothing caps the grid. Once the ranks sit on
// different cards (peer pointers through CUDA IPC), the kernel must first
// wait at an entry barrier (all_rank_barrier of ring_common.cuh) until
// every rank's K/V have been written.
//
// Skipping masked work is exact. Under causal, a block with src > me lies
// wholly after every query of rank me, and in the block src == me a key
// tile that starts after the CTA's last query row is masked for every row
// of the CTA. For such a tile every S is -inf, so m_new = m and p = 0: if m
// is finite, safe_m = m and corr = exp(0) = 1, leaving l and acc as they
// were; if m is -inf, no key has been seen, l and acc are 0 and stay 0.
// Skipping the tile gives the same m, l and acc, bit for bit, and halves
// the causal work.
//
// What bounds it: operations. The least work is 4·h·d·S² flops over the
// whole sequence of S = n·s positions (half that, plus the diagonal, under
// causal) against 2·(h + h_kv)·S·d elements moved, hundreds of flops a
// byte. Only the tensor cores reach that rate, so the route is chosen by
// dtype:
//
// float: ring_flash_attn_kernel, float FMAs on CUDA cores, so float inputs
// keep their full precision: every product is an IEEE f32 FFMA. Those
// FFMAs bound it, at 67 TFLOP/s on the H100: at the GQA block's shape in
// f32 (8 ranks x 1024 rows, 32 heads over 8, d 128, causal) its 5.50e11
// flops take 8.21 ms, its bytes 0.10 ms. The first version of this route
// took 24.869 ms there (chip_smoke.py; NVIDIA H100 80GB HBM3, 700.00 W), a
// third of that rate, for four reasons, each answered here:
// - shared memory set the pace: a thread held 4 x 4 scores and read each
//   operand with a 32-bit load, 2 to 2.7 FFMA a load. Now a CTA of
//   kF32Threads = 256 (16 x 16) takes kF32BQ = 128 query rows (kF32BQ256
//   = 64 at DT 256) and key tiles of kF32BK = 64; thread (ty, tx) holds
//   rows ty + 16i of S and O (8 of them), keys tx + 16j of S (4) and head
//   columns 4tx + 64c + 0..3 of O (8 at DT 128), and reads its operands
//   with 128-bit loads: S steps d four columns at a time (8 Q and 4 K
//   loads for 128 FFMA), P·V four keys at a time (8 P and 8 V loads for
//   256). A warp is 2 rows x 16 lanes, so a Q or P load is a broadcast of
//   2 addresses and a K or V load 16 distinct 16-byte words; Q, K and V
//   rows are padded by 4 floats and P rows by 16, so consecutive rows sit
//   on other banks and each load takes one or two wavefronts. A row's max
//   and sum take 4 shuffles within its 16 lanes;
// - no copy overlapped a product: K and then V of a tile went through one
//   buffer by scalar loads, four barriers a tile. Now K and V have a buffer
//   each, filled by cp.async (16 bytes a copy where d % 4 == 0 and the
//   blocks are 16-byte aligned, else 4; zeros beyond s and d), and the
//   copies leapfrog: V(i) is issued before S(i) and its softmax, K(i + 1)
//   before P·V(i), so each copy overlaps a product and a tile takes two
//   barriers. Q is copied once per CTA and scaled in place;
// - the DT 32 instance spilled; no instance may now (chip_smoke.py fails
//   on a stack frame or spill, and on an instance without LDS.128);
// - a CTA did 64 rows of a tile between four barriers; now one CTA of 256
//   threads an SM (172 KiB of shared memory at DT 128) does 128 rows between
//   two, four times the FFMAs a barrier.
// P goes through shared memory to the P·V product.
//
// half and bfloat16: ring_flash_attn_tc_kernel, warpgroup tensor cores
// (wgmma.mma_async m64n64k16, f32 accumulators). A CTA of 384 threads
// takes kTcBQ = 128 query rows of one head of one rank: two consumer
// warpgroups of 64 rows each and one producer warpgroup, which hands its
// registers to the consumers (setmaxnreg 40 / 232). The producer streams
// the K and V tiles of 64 keys through a ring of stages in shared memory,
// each guarded by a full and an empty mbarrier, in wgmma's 128-byte
// swizzle. Where d is 64, 128 or 256 and the blocks are 16-byte aligned it
// uses TMA: one 64 x 64 box per panel from a tensor map of each rank's K
// and V, built on the host for each launch and passed in the kernel's
// parameters (18.5 KB at 64 ranks, under the 32 KB that CUDA 12.1 allows;
// the maps stay out of device memory, so a launch allocates nothing).
// TMA is kept beside cp.async because it is faster where both apply: at
// the GQA block's shape (8 ranks x 1024 rows, 32 heads over 8, d 128, bf16,
// causal) the kernel takes 1.30 ms with TMA and 1.55 ms with cp.async for
// every tile, its copies alone 0.475 and 0.567 ms (tools/
// attention_ablation.py, NVIDIA H100 80GB HBM3, 700 W): one thread issues
// whole boxes and the producer's other threads idle at 40 registers.
// Elsewhere it copies with cp.async, 16 bytes a thread (d % 8 == 0), or
// 2-byte loads, computing the swizzle by hand. Rows beyond s and columns
// beyond d land as zeros (TMA's and cp.async's zero fill), so the tensor
// cores never multiply stale bits. A consumer warpgroup computes
// - S = Q·Kᵀ: B is the K tile, K-major in shared memory; A is its Q tile,
//   held in registers up to d = 128 (so S reads only K from shared
//   memory), else K-major in shared memory. Products of 16-bit values are
//   exact in f32 and sum in f32; `scale` (folded with log2 e for exp2)
//   multiplies S after the product, since rounding q·scale to 16 bits
//   would move S by 2^-9 relatively;
// - the softmax on the accumulator registers: each row belongs to the 4
//   threads of a quad, so its max and sum take two shuffles; p =
//   ex2(S·scale·log2 e - m) on the special-function unit;
//   masking is one branch per tile, taken only by the diagonal block's
//   tiles and a ragged last tile;
// - O += P·V: A is P from registers (the accumulator layout of S is
//   wgmma's A-fragment layout), B the V tile, MN-major through the
//   transpose bit. P enters as two 16-bit halves, hi = rn(p) and
//   lo = rn(p - hi), each its own wgmma into the same accumulator: about
//   16 bits of p, where one rounding would leave 8 (bf16). For half, p is
//   computed times 2^15 (l too, so o = acc / l is unchanged) so that lo
//   stays clear of half's subnormals. O is rescaled only when a row max
//   of the warp moved.
// The P·V of one tile runs on the tensor cores while the softmax of the
// next runs on the CUDA cores: S of tile i + 1 is issued just before P·V
// of tile i and waited for alone. The diagonal block's tile after a
// warpgroup's last query is computed, not skipped: all its p are 0 and its
// corr is exp2(0) = 1, so it leaves m, l and o as they were.
// Head dims are padded with zeros to a panel of 64 (DT = 64, 128 or 256).
//
// Limits: 1 <= d <= 256 (the widest register tile), n <= kMaxRanks (the
// pointer table travels in the launch's parameters), h <= 65535 (grid y).
// The wrapper (ucc_tpu_torch/kernels/ring_attention.py) refuses the rest.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxRanks = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q[kMaxRanks];
  const void* k[kMaxRanks];
  const void* v[kMaxRanks];
  void* o[kMaxRanks];
  int n, h, h_kv, s, d;
  float scale;
  int causal;
};

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// float: register tiles on the CUDA cores
// ---------------------------------------------------------------------------

// The f32 route's tiles: query rows of a CTA and keys of a tile, at DT <=
// 128 and at DT 256 (whose O tile is twice as wide, so it takes half the
// rows rather than spill). tools/attention_f32_depth.py builds copies with
// other values by substituting these lines.
constexpr int kF32Threads = 256;        // 16 x 16
constexpr int kF32BQ = 128;
constexpr int kF32BK = 64;
constexpr int kF32BQ256 = 64;
constexpr int kF32BK256 = 64;

template <int DT> struct F32Tile {
  static constexpr int kBQ = DT == 256 ? kF32BQ256 : kF32BQ;
  static constexpr int kBK = DT == 256 ? kF32BK256 : kF32BK;
  static constexpr int kRows = kBQ / 16;     // rows of S and O a thread
  static constexpr int kKeys = kBK / 16;     // keys of S a thread
  static constexpr int kCols = DT / 16;      // head columns of O a thread
  static constexpr int kVec = kCols < 4 ? kCols : 4;   // floats a V load
  // Q, K and V rows: 4 floats of padding put consecutive rows on other
  // 16-byte bank groups; P rows: 16, so rows ty and ty + 1 do too
  static constexpr int kStride = DT + 4;
  static constexpr int kPStride = kBK + 16;
  static constexpr int kSmem =
      (int)sizeof(float) * ((kBQ + 2 * kBK) * kStride + kBQ * kPStride);
  static_assert(kBQ % 16 == 0 && kBK % 16 == 0, "16 x 16 threads");
  static_assert(kSmem <= 232448, "a block has at most 227 KB");
};

// one 16-byte (VEC) or 4-byte cp.async; `ok` false writes zeros and reads
// nothing (`src` must still be a valid address)
template <bool VEC>
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             bool ok) {
  if (VEC)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
}

// rows [r0, r0 + ROWS) of an (s, d) block into a [ROWS][DT + 4] tile by
// cp.async, 4 floats a copy (VEC) or 1; zeros beyond s and d, so a ragged
// tile adds nothing. Issued, not committed.
template <int DT, int ROWS, bool VEC>
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          int r0, int s, int d) {
  constexpr int kW = VEC ? 4 : 1;
  constexpr int kPer = DT / kW;               // copies a row
#pragma unroll 4
  for (int idx = threadIdx.x; idx < ROWS * kPer; idx += kF32Threads) {
    const int r = idx / kPer, c = idx % kPer * kW;
    const bool ok = r0 + r < s && c < d;
    cp_async_f32<VEC>(dst + r * (DT + 4) + c,
                      ok ? src + (size_t)(r0 + r) * d + c : src, ok);
  }
}

// what copy_tile<DT, ROWS, VEC> of this thread wrote, times `mul`, once
// those copies have landed (a thread sees its own cp.async writes after
// its wait)
template <int DT, int ROWS, bool VEC>
__device__ __forceinline__ void scale_tile(float* dst, float mul) {
  constexpr int kW = VEC ? 4 : 1;
  constexpr int kPer = DT / kW;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < ROWS * kPer; idx += kF32Threads) {
    float* at = dst + idx / kPer * (DT + 4) + idx % kPer * kW;
#pragma unroll
    for (int e = 0; e < kW; ++e) at[e] *= mul;
  }
}

// N consecutive floats of shared memory in one load (N = 4: LDS.128)
template <int N>
__device__ __forceinline__ void lds(float (&x)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x, x[1] = v.y;
  } else {
    x[0] = *p;
  }
}

// max and sum over the 16 lanes of a row (a half warp)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <int DT, bool VEC>
__global__ void __launch_bounds__(kF32Threads, 1) ring_flash_attn_kernel(
    const Args a) {
  using F = F32Tile<DT>;
  constexpr int BQ = F::kBQ, BK = F::kBK, TM = F::kRows, TN = F::kKeys;
  constexpr int TD = F::kCols, VW = F::kVec, QS = F::kStride;
  constexpr int PS = F::kPStride;
  extern __shared__ float4 f32_smem[];
  float* sq = reinterpret_cast<float*>(f32_smem);   // [BQ][QS]: q·scale·log2 e
  float* sk = sq + BQ * QS;                          // [BK][QS]: K of tile i
  float* sv = sk + BK * QS;                          // [BK][QS]: V of tile i
  float* sp = sv + BK * QS;                          // [BQ][PS]: p of tile i

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n = a.n, s = a.s, d = a.d;
  const bool causal = a.causal != 0;
  // the ranks and query tiles with the most causal work are dispatched first
  const int me = n - 1 - (int)blockIdx.z;
  const int q0 = ((int)gridDim.x - 1 - (int)blockIdx.x) * BQ;
  const int head = blockIdx.y;
  const int kvh = head / (a.h / a.h_kv);
  const size_t q_off = (size_t)head * s * d;
  const size_t kv_off = (size_t)kvh * s * d;

  // The CTA's key tiles in order: the ring's blocks t = 0, 1, ... (src =
  // me - t), skipping wholly masked blocks and, in the diagonal block, the
  // tiles after the CTA's last query. Under causal the diagonal block is t
  // = 0 and the blocks kept are t <= me. (src, j0) is the tile whose K is
  // in (or on its way to) sk.
  int src = me, j0 = 0, end = causal ? min(s, q0 + BQ) : s;
  const int count = (end + BK - 1) / BK + (causal ? me : n - 1) *
                                              ((s + BK - 1) / BK);
  auto kv_block = [&](const void* const* blocks, int r) {
    return static_cast<const float*>(blocks[r]) + kv_off;
  };

  copy_tile<DT, BQ, VEC>(sq, static_cast<const float*>(a.q[me]) + q_off, q0,
                         s, d);
  copy_tile<DT, BK, VEC>(sk, kv_block(a.k, src), 0, s, d);
  cp_async_commit();
  cp_async_wait<0>();
  scale_tile<DT, BQ, VEC>(sq, a.scale * kLog2e);
  __syncthreads();

  float m[TM], l[TM], acc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < TD; ++c) acc[i][c] = 0.f;
  }

  for (int it = 0; it < count; ++it) {
    const int t_src = src, t_j0 = j0;
    copy_tile<DT, BK, VEC>(sv, kv_block(a.v, t_src), t_j0, s, d);
    cp_async_commit();

    // S = (q·scale·log2 e)·Kᵀ, four head columns a step
    float sc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DT; c += 4) {
      float qv[TM][4], kv[TN][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) lds(qv[i], sq + (ty + 16 * i) * QS + c);
#pragma unroll
      for (int j = 0; j < TN; ++j) lds(kv[j], sk + (tx + 16 * j) * QS + c);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            sc[i][j] = fmaf(qv[i][e], kv[j][e], sc[i][j]);
    }

    // the online softmax of rows ty + 16i; masking only where a key may be
    // beyond s or, in the diagonal block, after a row of the CTA
    const bool diag = causal && t_src == me;
    const bool edge = t_j0 + BK > s || (diag && t_j0 + BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int key = t_j0 + tx + 16 * j;
        if (edge && (key >= s || (diag && key > row))) sc[i][j] = -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      // exp(-inf - -inf) would be NaN; fully masked rows keep p = 0
      const float safe_m = isfinite(m_new) ? m_new : 0.f;
      const float corr = isfinite(m[i]) ? exp2f(m[i] - safe_m) : 0.f;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = isfinite(sc[i][j]) ? exp2f(sc[i][j] - safe_m) : 0.f;
        sp[(ty + 16 * i) * PS + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * corr + row_sum(rs);
#pragma unroll
      for (int c = 0; c < TD; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }

    cp_async_wait<0>();
    __syncthreads();              // V(i) and P(i) are in, K(i) is read
    j0 += BK;
    if (j0 >= end) {
      j0 = 0;
      end = s;
      src = src == 0 ? n - 1 : src - 1;
    }
    if (it + 1 < count) {
      copy_tile<DT, BK, VEC>(sk, kv_block(a.k, src), j0, s, d);
      cp_async_commit();
    }

    // O += P·V, four keys a step; a thread's columns are VW·tx + 16·VW·cc
#pragma unroll 4
    for (int k = 0; k < BK; k += 4) {
      float pv[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) lds(pv[i], sp + (ty + 16 * i) * PS + k);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int cc = 0; cc < TD / VW; ++cc) {
          float vv[VW];
          lds(vv, sv + (k + e) * QS + VW * tx + 16 * VW * cc);
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int u = 0; u < VW; ++u)
              acc[i][VW * cc + u] = fmaf(pv[i][e], vv[u], acc[i][VW * cc + u]);
        }
    }

    cp_async_wait<0>();
    __syncthreads();              // K(i + 1) is in, P(i) and V(i) are read
  }

  float* o = static_cast<float*>(a.o[me]) + q_off;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s) continue;
    const float den = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int cc = 0; cc < TD / VW; ++cc) {
      const int col = VW * tx + 16 * VW * cc;
      float x[VW];
#pragma unroll
      for (int u = 0; u < VW; ++u) x[u] = acc[i][VW * cc + u] / den;
      float* at = o + (size_t)row * d + col;
      if constexpr (VEC && VW == 4) {
        // d % 4 == 0 and o 16-byte aligned: col < d holds the whole vector
        if (col < d)
          *reinterpret_cast<float4*>(at) = make_float4(x[0], x[1], x[2], x[3]);
      } else {
#pragma unroll
        for (int u = 0; u < VW; ++u)
          if (col + u < d) at[u] = x[u];
      }
    }
  }
}

template <int DT, bool VEC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using F = F32Tile<DT>;
  cudaError_t e = cudaFuncSetAttribute(
      ring_flash_attn_kernel<DT, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, F::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.s + F::kBQ - 1) / F::kBQ, a.h, a.n);
  ring_flash_attn_kernel<DT, VEC><<<grid, kF32Threads, F::kSmem, stream>>>(a);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t by_dim(const Args& a, cudaStream_t stream) {
  if (a.d <= 16) return launch<16, VEC>(a, stream);
  if (a.d <= 32) return launch<32, VEC>(a, stream);
  if (a.d <= 64) return launch<64, VEC>(a, stream);
  if (a.d <= 128) return launch<128, VEC>(a, stream);
  return launch<256, VEC>(a, stream);
}

// 16-byte copies where rows are whole vectors and every block (o too, for
// its float4 stores) is 16-byte aligned; else 4-byte copies
cudaError_t cuda_cores(const Args& a, cudaStream_t stream) {
  bool aligned = a.d % 4 == 0;
  for (int r = 0; r < a.n; ++r)
    aligned = aligned && (reinterpret_cast<uintptr_t>(a.q[r]) |
                          reinterpret_cast<uintptr_t>(a.k[r]) |
                          reinterpret_cast<uintptr_t>(a.v[r]) |
                          reinterpret_cast<uintptr_t>(a.o[r])) % 16 == 0;
  return aligned ? by_dim<true>(a, stream) : by_dim<false>(a, stream);
}

// ---------------------------------------------------------------------------
// half and bfloat16: warpgroup tensor cores
// ---------------------------------------------------------------------------

constexpr int kConsumers = 2;                      // warpgroups of 64 rows
constexpr int kTcThreads = (kConsumers + 1) * 128;  // + a producer
constexpr int kTcBQ = kConsumers * 64;             // query rows of a CTA
constexpr int kTcBK = 64;                          // key rows of a tile
constexpr int kPanel = 64 * 128;   // bytes of a panel: 64 rows x 128 B
// an mbarrier wait that has not completed after this many cycles (~10 s)
// traps, so a fault ends the launch with an error instead of hanging
constexpr long long kSpinCycles = 20000000000LL;

#define UCC_ACC32                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])
#define UCC_REGS32                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}"

// wgmma m64n64k16 with f32 accumulators d[32] of a 64 x 64 tile; `acc` = 0
// overwrites d. ss takes A and B from shared memory, both K-major; rs
// takes A from registers and B K-major (TRANS_B = 0) or MN-major (1).
#define UCC_WGMMA_FORMS(AB)                                                \
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,    \
                                            uint64_t b, int acc) {         \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"              \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB " "      \
                 UCC_REGS32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"              \
                 : UCC_ACC32                                               \
                 : "l"(a), "l"(b), "r"(acc));                              \
  }                                                                        \
  template <int TRANS_B>                                                   \
  static __device__ __forceinline__ void rs(                               \
      float (&d)[32], const uint32_t (&x)[4], uint64_t b, int acc) {       \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"              \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB " "      \
                 UCC_REGS32 ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"\
                 : UCC_ACC32                                               \
                 : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "l"(b),     \
                   "r"(acc), "n"(TRANS_B));                                \
  }

// per 16-bit type: the wgmma forms, a pair of floats rounded into one
// 32-bit register (the lower column in the low half), and log2 of the
// factor p is computed times
template <typename T> struct Tc;

// (cvt's first source goes to the upper half)
template <> struct Tc<__nv_bfloat16> {
  static constexpr float kPLog2 = 0.f;
  static __device__ __forceinline__ uint32_t pack(float x, float y) {
    uint32_t u;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(u) : "f"(y), "f"(x));
    return u;
  }
  static __device__ __forceinline__ float2 unpack(uint32_t u) {
    return make_float2(__uint_as_float(u << 16),
                       __uint_as_float(u & 0xffff0000u));
  }
  UCC_WGMMA_FORMS("bf16.bf16")
};

template <> struct Tc<__half> {
  // 2^15: lo = rn(p - hi) of p down to ~4e-6 stays a normal half
  static constexpr float kPLog2 = 15.f;
  static __device__ __forceinline__ uint32_t pack(float x, float y) {
    uint32_t u;
    asm("cvt.rn.f16x2.f32 %0, %1, %2;" : "=r"(u) : "f"(y), "f"(x));
    return u;
  }
  static __device__ __forceinline__ float2 unpack(uint32_t u) {
    float2 f;
    asm("{\n.reg .f16 lo, hi;\nmov.b32 {lo, hi}, %2;\ncvt.f32.f16 %0, lo;\n"
        "cvt.f32.f16 %1, hi;\n}\n"
        : "=f"(f.x), "=f"(f.y)
        : "r"(u));
    return f;
  }
  UCC_WGMMA_FORMS("f16.f16")
};

// 2^x on the special-function unit (relative error ~2^-22; results below
// 2^-126 flush to 0, far under every tolerance here)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// wgmma's matrix descriptor of a tile in the 128-byte swizzled layout:
// start address, leading and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
// registers a wgmma reads or writes asynchronously: the compiler must
// neither move their accesses across the fence and wait nor reuse them
template <int N> __device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N> __device__ __forceinline__ void keep(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int M, int N>
__device__ __forceinline__ void keep(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) keep(r[i]);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, "
               "[%0];\n}\n" ::"r"(bar)
               : "memory");
}
// waits until the phase of parity `parity` of the barrier has completed.
// Unlike the ring kernels' spins, which wait on a peer and report a
// timeout through a sticky error word, nothing outside the CTA can hold
// these barriers (K/V are read through pointers, with no flags), so a stall
// is a fault of this kernel. It traps: the wrapper does not synchronize, and
// an early exit would hand back a partly written o as a result, where the
// trap makes the next CUDA call of the process fail.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64"
                 " p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done)
                 : "r"(bar), "r"(parity)
                 : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > kSpinCycles) __trap();
  }
}

// this thread's shared-memory writes, made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// How a tile reaches shared memory: 2-byte loads; 16-byte cp.async (d % 8
// == 0 and 16-byte aligned blocks); or TMA for K and V (d == DT, so every
// 64-column panel is one box; Q still by cp.async)
enum Load { kScalar, kCpAsync, kTma };

// rows [r0, r0 + 64) of an (s, d) block into the 64 x DT tile at shared
// address `tile` (1024-aligned), in wgmma's 128-byte swizzle: panels of 64
// columns, each 64 rows x 128 B; the 16-byte chunk c of row r sits at
// r·128 + ((c ^ r) & 7)·16 of its panel (TMA's CU_TENSOR_MAP_SWIZZLE_128B
// writes the same). Zeros beyond s and d. VEC: 16-byte cp.async, else
// 2-byte loads.
template <typename T, int DT, bool VEC>
__device__ __forceinline__ void load_tile_tc(uint32_t tile, const T* src,
                                             int r0, int s, int d, int lane,
                                             int nthreads) {
  constexpr int kChunks = DT / 8;
  const uint16_t* src16 = reinterpret_cast<const uint16_t*>(src);
  for (int idx = lane; idx < 64 * kChunks; idx += nthreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    const uint32_t dst = tile + (c >> 3) * kPanel + r * 128 +
                         (((c ^ r) & 7) << 4);
    const int row = r0 + r, col = c * 8;
    if (VEC) {
      const bool ok = row < s && col < d;
      const T* from = ok ? src + (size_t)row * d + col : src;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       dst),
                   "l"(from), "r"(ok ? 16 : 0)
                   : "memory");
    } else {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t lo = 0, hi = 0;
        if (row < s && col + 2 * i < d)
          lo = src16[(size_t)row * d + col + 2 * i];
        if (row < s && col + 2 * i + 1 < d)
          hi = src16[(size_t)row * d + col + 2 * i + 1];
        w[i] = lo | hi << 16;
      }
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                   "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                   : "memory");
    }
  }
}

// The CTA's key tiles in order: the ring's blocks t = 0, 1, ... (src =
// me - t), skipping wholly masked blocks and, in the diagonal block, the
// tiles after the CTA's last query, exactly as ring_flash_attn_kernel does.
// Under causal the diagonal block is t = 0 and the blocks kept are
// t <= me. The producer and the consumers each walk their own copy.
struct TileWalk {
  int count;             // tiles in all
  int src, j0, end;      // the current tile: block src, keys [j0, j0 + 64)
  int n, s;
  __device__ TileWalk(const Args& a, int me, int q0)
      : src(me), j0(0), n(a.n), s(a.s) {
    const int full = (s + kTcBK - 1) / kTcBK;
    end = a.causal ? min(s, q0 + kTcBQ) : s;
    count = (end + kTcBK - 1) / kTcBK + (a.causal ? me : n - 1) * full;
  }
  __device__ __forceinline__ void next() {
    j0 += kTcBK;
    if (j0 >= end) {
      j0 = 0;
      end = s;
      src = src == 0 ? n - 1 : src - 1;
    }
  }
};

// the tensor-core kernel's parameters: 18.5 KB with the TMA maps, within
// the 32 KB that kernel parameters may take since CUDA 12.1
struct TcArgs {
  Args a;
  CUtensorMap k[kMaxRanks], v[kMaxRanks];   // each rank's K and V (kTma)
};

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 "
               "st, [%0], %1;\n}\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// one 64 x 64 box of a (d, s, heads) tensor map into shared memory,
// completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int col, int row, int head,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(head)
      : "memory");
}

template <typename T, int DT, int STAGES, int LOAD>
__global__ void __launch_bounds__(kTcThreads, 1)
    ring_flash_attn_tc_kernel(const __grid_constant__ TcArgs ta) {
  constexpr bool VEC = LOAD != kScalar;
  const Args& a = ta.a;
  constexpr int kTile = 64 * DT * 2;        // bytes of a 64-row tile
  constexpr int kPanels = DT / 64;
  extern __shared__ uint8_t tc_smem[];
  __shared__ uint64_t full[STAGES], empty[STAGES];
  // swizzled tiles must start on 1024 bytes: kConsumers Q tiles, then per
  // stage a K tile and a V tile
  const uint32_t sq = (smem_addr(tc_smem) + 1023) & ~1023u;
  const uint32_t skv = sq + kConsumers * kTile;

  const int s = a.s, d = a.d;
  // the ranks and query tiles with the most causal work are dispatched first
  const int me = a.n - 1 - (int)blockIdx.z;
  const int q0 = ((int)gridDim.x - 1 - (int)blockIdx.x) * kTcBQ;
  const int head = blockIdx.y;
  const int kvh = head / (a.h / a.h_kv);
  const size_t q_off = (size_t)head * s * d;
  const size_t kv_off = (size_t)kvh * s * d;
  TileWalk walk(a, me, q0);

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(smem_addr(&full[i]), LOAD == kTma ? 1 : 128);
      mbar_init(smem_addr(&empty[i]), kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  if (wg == kConsumers) {
    // producer warpgroup: tile i goes to stage i % STAGES once the
    // consumers have released it, and its full barrier is signalled once
    // its copies have landed. With 3 stages or more, tile i is issued
    // before tile i - 1 is waited for and signalled, so one tile is always
    // in flight; with 2 that would deadlock, since the consumers release a
    // tile only once the next one has arrived.
    constexpr bool kAhead = STAGES >= 3;
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (LOAD == kTma) {
      // one thread issues the boxes; the barrier counts their bytes
      if (tid == 0) {
        for (int i = 0; i < walk.count; ++i, walk.next()) {
          const int st = i % STAGES;
          const uint32_t bar = smem_addr(&full[st]);
          mbar_wait(smem_addr(&empty[st]), ((i / STAGES) & 1) ^ 1);
          mbar_expect_tx(bar, 2 * kTile);
          const uint32_t kt = skv + st * 2 * kTile;
#pragma unroll
          for (int p = 0; p < kPanels; ++p) {
            tma_load(kt + p * kPanel, &ta.k[walk.src], 64 * p, walk.j0, kvh,
                     bar);
            tma_load(kt + kTile + p * kPanel, &ta.v[walk.src], 64 * p,
                     walk.j0, kvh, bar);
          }
        }
      }
    } else {
      for (int i = 0; i < walk.count; ++i, walk.next()) {
        const int st = i % STAGES;
        mbar_wait(smem_addr(&empty[st]), ((i / STAGES) & 1) ^ 1);
        const uint32_t kt = skv + st * 2 * kTile;
        load_tile_tc<T, DT, VEC>(kt, static_cast<const T*>(a.k[walk.src]) +
                                         kv_off, walk.j0, s, d, tid, 128);
        load_tile_tc<T, DT, VEC>(kt + kTile, static_cast<const T*>(
                                     a.v[walk.src]) + kv_off, walk.j0, s,
                                 d, tid, 128);
        cp_async_commit();
        if (!kAhead) {
          cp_async_wait<0>();
          fence_async_smem();
          mbar_arrive(smem_addr(&full[st]));
        } else if (i > 0) {
          cp_async_wait<1>();
          fence_async_smem();
          mbar_arrive(smem_addr(&full[(i - 1) % STAGES]));
        }
      }
      if (kAhead) {
        cp_async_wait<0>();
        fence_async_smem();
        mbar_arrive(smem_addr(&full[(walk.count - 1) % STAGES]));
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = tid % 32, g = lane / 4, tq = lane % 4;
    const int wg_first = q0 + wg * 64;
    // this thread's query rows (local positions): qa and qa + 8
    const int qa = wg_first + (tid / 32) * 16 + g;
    const uint32_t my_q = sq + wg * kTile;
    load_tile_tc<T, DT, VEC>(my_q, static_cast<const T*>(a.q[me]) + q_off,
                             wg_first, s, d, tid, 128);
    cp_async_commit();
    cp_async_wait<0>();
    fence_async_smem();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    // up to d = 128 Q stays in registers as S's A operand (kk-th slice in
    // A-fragment order: rows r0, r0 + 8 and columns 16kk + 2tq (+8)), so
    // S reads only K from shared memory; at d = 256 the registers go to o
    constexpr bool kQRegs = DT <= 128;
    uint32_t qf[kQRegs ? DT / 16 : 1][4];
    if constexpr (kQRegs) {
      const int r0 = (tid / 32) * 16 + g;
#pragma unroll
      for (int kk = 0; kk < DT / 16; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int r = r0 + 8 * (f & 1), c = 16 * kk + 2 * tq + 8 * (f >> 1);
          const uint32_t at = my_q + (c >> 6) * kPanel + r * 128 +
                              ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
          asm volatile("ld.shared.b32 %0, [%1];\n"
                       : "=r"(qf[kk][f])
                       : "r"(at));
        }
    }

    float o[kPanels][32];
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[p][e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
    float sc[32];                 // S of a tile, then its p
    uint32_t ph[16], pl[16];      // p in A-fragment order, hi and lo
    const float sl2 = a.scale * kLog2e;

    // S = Q·Kᵀ of tile i into sc, issued and committed, not waited for
    auto issue_s = [&](int i) {
      const uint32_t kt = skv + (i % STAGES) * 2 * kTile;
#pragma unroll
      for (int kk = 0; kk < DT / 16; ++kk) {
        const uint32_t off = (kk / 4) * kPanel + (kk % 4) * 32;
        if constexpr (kQRegs)
          Tc<T>::template rs<0>(sc, qf[kk], sw128_desc(kt + off, 16, 1024),
                                kk > 0);
        else
          Tc<T>::ss(sc, sw128_desc(my_q + off, 16, 1024),
                    sw128_desc(kt + off, 16, 1024), kk > 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    };
    // sc of the walk's current tile -> p in place, m, l and corr updated;
    // o is not touched
    auto softmax = [&]() {
      const int j0 = walk.j0;
      const bool diag = a.causal && walk.src == me;
      float mx[2] = {-INFINITY, -INFINITY}, sm[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] *= sl2;
      // sc[4j + e]: row qa + 8·(e >> 1), key j0 + 8j + 2tq + (e & 1)
      if (j0 + kTcBK > s || (diag && j0 + kTcBK - 1 > wg_first)) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int key = j0 + 8 * (e >> 2) + 2 * tq + (e & 1);
          if (key >= s || (diag && key > qa + 8 * ((e >> 1) & 1)))
            sc[e] = -INFINITY;
        }
      }
#pragma unroll
      for (int e = 0; e < 32; ++e)
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        // exp(-inf - -inf) would be NaN; fully masked rows keep p = 0
        const float safe_m = m_new == -INFINITY ? 0.f : m_new;
        corr[r] = ex2(m[r] - safe_m);
        m[r] = m_new;
        sm[r] = safe_m - Tc<T>::kPLog2;
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        sc[e] = ex2(sc[e] - sm[(e >> 1) & 1]);
        rs[(e >> 1) & 1] += sc[e];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(kFull, rs[r], 1);
        rs[r] += __shfl_xor_sync(kFull, rs[r], 2);
        l[r] = l[r] * corr[r] + rs[r];
      }
    };
    // o rescaled by corr (skipped when every corr of the warp's rows is
    // 1, which leaves o as it is); p split into A fragments: slice kk
    // (keys 16kk..16kk+15) is sc[8kk .. 8kk+7] as four pairs, hi and lo
    auto rescale_split = [&]() {
      if (__any_sync(kFull, corr[0] != 1.f || corr[1] != 1.f))
#pragma unroll
        for (int p = 0; p < kPanels; ++p)
#pragma unroll
          for (int e = 0; e < 32; ++e) o[p][e] *= corr[(e >> 1) & 1];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        ph[e] = Tc<T>::pack(sc[2 * e], sc[2 * e + 1]);
        const float2 h2 = Tc<T>::unpack(ph[e]);
        pl[e] = Tc<T>::pack(sc[2 * e] - h2.x, sc[2 * e + 1] - h2.y);
      }
    };

    // O += P·V of tile i, issued and committed, not waited for
    auto issue_pv = [&](int i) {
      const uint32_t vt = skv + (i % STAGES) * 2 * kTile + kTile;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t hi[4] = {ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2],
                                ph[4 * kk + 3]};
        const uint32_t lo[4] = {pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2],
                                pl[4 * kk + 3]};
#pragma unroll
        for (int p = 0; p < kPanels; ++p) {
          const uint64_t vd =
              sw128_desc(vt + p * kPanel + kk * 16 * 128, kPanel, 1024);
          Tc<T>::template rs<1>(o[p], hi, vd, 1);
          Tc<T>::template rs<1>(o[p], lo, vd, 1);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    };
    auto keep_pv = [&]() {
      keep(ph);
      keep(pl);
#pragma unroll
      for (int p = 0; p < kPanels; ++p) keep(o[p]);
    };

    // Tile i's P·V runs on the tensor cores while the softmax of tile
    // i + 1 runs on the CUDA cores: S of i + 1 is issued just before P·V
    // of i, and waited for alone (wait_group 1). Every wgmma of the loop
    // is unconditional, or ptxas cannot match the waits to their groups
    // and serializes the wgmmas; the last tile's P·V follows the loop.
    mbar_wait(smem_addr(&full[0]), 0);
    wg_fence();
    issue_s(0);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    keep(sc);
    keep(qf);
    softmax();
    rescale_split();
    for (int i = 0; i + 1 < walk.count; ++i) {
      mbar_wait(smem_addr(&full[(i + 1) % STAGES]), ((i + 1) / STAGES) & 1);
      keep_pv();
      wg_fence();
      issue_s(i + 1);
      issue_pv(i);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      keep(sc);
      keep(qf);
      walk.next();
      softmax();
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      keep_pv();
      mbar_arrive(smem_addr(&empty[i % STAGES]));
      rescale_split();
    }
    keep_pv();
    wg_fence();
    issue_pv(walk.count - 1);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    keep_pv();
    mbar_arrive(smem_addr(&empty[(walk.count - 1) % STAGES]));

    // o[p][4j + e]: row qa + 8·(e >> 1), column 64p + 8j + 2tq + (e & 1)
    T* ob = static_cast<T*>(a.o[me]) + q_off;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qa + 8 * r;
      if (row >= s) continue;
      const float den = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
      for (int p = 0; p < kPanels; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * p + 8 * j + 2 * tq;
          const float x = o[p][4 * j + 2 * r] / den;
          const float y = o[p][4 * j + 2 * r + 1] / den;
          T* at = ob + (size_t)row * d + col;
          if (VEC) {
            if (col < d) *reinterpret_cast<uint32_t*>(at) = Tc<T>::pack(x, y);
          } else {
            if (col < d) *at = from_f32<T>(x);
            if (col + 1 < d) at[1] = from_f32<T>(y);
          }
        }
    }
  }
}

template <typename T, int DT, int LOAD>
cudaError_t launch_tc(const TcArgs& ta, cudaStream_t stream) {
  // two stages of K and V at d = 256 (192 KB with Q), four below
  constexpr int kStages = DT == 256 ? 2 : 4;
  constexpr size_t smem = 1024 + (size_t)(kConsumers + 2 * kStages) * 64 *
                                     DT * 2;
  cudaError_t e = cudaFuncSetAttribute(
      ring_flash_attn_tc_kernel<T, DT, kStages, LOAD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((ta.a.s + kTcBQ - 1) / kTcBQ, ta.a.h, ta.a.n);
  ring_flash_attn_tc_kernel<T, DT, kStages, LOAD>
      <<<grid, kTcThreads, smem, stream>>>(ta);
  return cudaGetLastError();
}

template <typename T, int LOAD>
cudaError_t by_dim_tc(const TcArgs& ta, cudaStream_t stream) {
  if (ta.a.d <= 64) return launch_tc<T, 64, LOAD>(ta, stream);
  if (ta.a.d <= 128) return launch_tc<T, 128, LOAD>(ta, stream);
  return launch_tc<T, 256, LOAD>(ta, stream);
}

// cuTensorMapEncodeTiled is a driver call: reached through the runtime's
// entry-point query, so the library links no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the map of one rank's (h_kv, s, d) block: 64 x 64 boxes, 128-byte
// swizzle, zeros outside
bool encode_block(EncodeTiled fn, CUtensorMap* map, const void* base,
                  CUtensorMapDataType type, const Args& a) {
  const cuuint64_t dims[3] = {(cuuint64_t)a.d, (cuuint64_t)a.s,
                              (cuuint64_t)a.h_kv};
  const cuuint64_t strides[2] = {(cuuint64_t)a.d * 2,
                                 (cuuint64_t)a.s * a.d * 2};
  const cuuint32_t box[3] = {64, 64, 1}, unit[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// TMA where every panel is one box (d == DT) and the blocks are 16-byte
// aligned; else 16-byte cp.async where rows are whole chunks; else 2-byte
// loads
template <typename T>
cudaError_t tensor_cores(TcArgs& ta, CUtensorMapDataType type,
                         cudaStream_t stream) {
  const Args& a = ta.a;
  bool aligned = true;
  for (int r = 0; r < a.n; ++r)
    aligned = aligned && (reinterpret_cast<uintptr_t>(a.q[r]) |
                          reinterpret_cast<uintptr_t>(a.k[r]) |
                          reinterpret_cast<uintptr_t>(a.v[r]) |
                          reinterpret_cast<uintptr_t>(a.o[r])) % 16 == 0;
  if (!aligned || a.d % 8 != 0) return by_dim_tc<T, kScalar>(ta, stream);
  if (a.d != 64 && a.d != 128 && a.d != 256)
    return by_dim_tc<T, kCpAsync>(ta, stream);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  for (int r = 0; r < a.n; ++r)
    if (!encode_block(fn, &ta.k[r], a.k[r], type, a) ||
        !encode_block(fn, &ta.v[r], a.v[r], type, a))
      return cudaErrorInvalidValue;
  return by_dim_tc<T, kTma>(ta, stream);
}

}  // namespace

extern "C" {

// Ring attention of n ranks on `stream`. `ptrs` is a host array of 4n
// device pointers: q of every rank, then k, v and o. dtype code
// (kernels/ring_attention.py:DTYPE_CODES): 0 float (CUDA cores), 1 half,
// 2 bfloat16 (tensor cores).
// Returns the launch's CUDA error (0 when it was queued).
int ucc_ring_flash_attn(int dtype, const void* const* ptrs, int n, int h,
                        int h_kv, int s, int d, float scale, int causal,
                        void* stream) {
  if (n < 1 || n > kMaxRanks || h_kv < 1 || h < h_kv || h % h_kv != 0 ||
      h > 65535 || s < 1 || d < 1 || d > 256)
    return cudaErrorInvalidValue;
  static thread_local TcArgs ta;   // 18.5 KB: kept off the stack
  Args& a = ta.a;
  a = Args{};
  for (int r = 0; r < n; ++r) {
    a.q[r] = ptrs[r];
    a.k[r] = ptrs[n + r];
    a.v[r] = ptrs[2 * n + r];
    a.o[r] = const_cast<void*>(ptrs[3 * n + r]);
  }
  a.n = n;
  a.h = h;
  a.h_kv = h_kv;
  a.s = s;
  a.d = d;
  a.scale = scale;
  a.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return cuda_cores(a, st);
    case 1:
      return tensor_cores<__half>(ta, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, st);
    case 2:
      return tensor_cores<__nv_bfloat16>(ta, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                         st);
    default: return cudaErrorInvalidValue;
  }
}

const char* ucc_ring_flash_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
