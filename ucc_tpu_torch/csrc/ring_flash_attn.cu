// Ring flash-attention forward of an n-rank sequence-parallel ring, as one
// kernel launch.
//
// Replaces ucc_tpu/fused_attention.py:_kernel (the Pallas kernel that
// fused_attention._build compiles). Rank `me` holds q (h, s, d) and k, v
// (h_kv, s, d) of T, its block of s consecutive sequence positions, and
// gets o (h, s, d) of T: exact softmax attention of its queries against
// the whole sequence. The arithmetic is the Pallas kernel's, step for step:
// - q is cast to float and multiplied by `scale` before the dot;
// - query head j reads K/V head j / (h / h_kv) (GQA, consecutive groups);
// - for t = 0..n-1 the K/V block of rank src = (me - t) mod n is folded in:
//   S = q·Kᵀ in float; under causal, S = -inf where the global query
//   position me·s + i is earlier than the key position src·s + j;
//   m_new = max(m, rowmax S); safe_m = isfinite(m_new) ? m_new : 0;
//   p = isfinite(S) ? exp(S - safe_m) : 0;
//   corr = isfinite(m) ? exp(m - safe_m) : 0;
//   l = l·corr + rowsum p; acc = acc·corr + p·V; m = m_new;
// - o = acc / (l == 0 ? 1 : l), rounded to T to nearest even.
// The kernel folds a block in key tiles of kBK rows, so one block is
// several such updates; the result differs from one update per block only
// by float rounding.
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
// byte. This first version is simple and right, not fast: float FMAs on
// CUDA cores (no tensor cores), so float inputs keep their full precision
// and 16-bit inputs are widened exactly. A CTA of 256 threads (16 x 16)
// takes kBQ = 64 query rows of one head of one rank; each thread owns 4
// rows x 4 score columns and 4 rows x d/16 output columns. The scaled Q
// tile stays in shared memory in float; K and then V of each key tile are
// staged through one float buffer (rows padded by one word, so the score
// loop's column reads are conflict-free), and P goes through shared memory
// to the P·V product. Row max and row sum are reduced across the 16 lanes
// of a row with shuffles. At d = 128 a CTA uses 86.5 KB of dynamic shared
// memory, so two fit on an SM. Tensor cores (mma/wgmma with P split into
// two bf16 halves), TMA and warp specialisation are later work.
//
// Limits: 1 <= d <= 256 (the widest register tile), n <= kMaxRanks (the
// pointer table travels in the launch's parameters), h <= 65535 (grid y).
// The wrapper (ucc_tpu_torch/kernels/ring_attention.py) refuses the rest.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxRanks = 64;
constexpr int kThreads = 256;           // 16 x 16
constexpr int kBQ = 64;                 // query rows of a CTA
constexpr int kBK = 64;                 // key rows of a tile
constexpr int kRows = kBQ / 16;         // query rows of a thread
constexpr int kCols = kBK / 16;         // score columns of a thread
constexpr int kPStride = kBK + 16;      // P rows: ty and ty+1 on other banks
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* q[kMaxRanks];
  const void* k[kMaxRanks];
  const void* v[kMaxRanks];
  void* o[kMaxRanks];
  int n, h, h_kv, s, d;
  float scale;
  int causal;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

constexpr size_t smem_bytes(int dt) {
  return sizeof(float) * ((size_t)(kBQ + kBK) * (dt + 1) +
                          (size_t)kBQ * kPStride);
}

// rows [r0, r0 + rows) of a (s, d) block into a [rows][DT + 1] float tile,
// times `mul`; zeros beyond s and d, so a ragged tile adds nothing
template <typename T, int DT, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int s, int d, float mul) {
  for (int idx = threadIdx.x; idx < ROWS * DT; idx += kThreads) {
    const int r = idx / DT, c = idx % DT;
    float x = 0.f;
    if (r0 + r < s && c < d) x = to_f32(src[(size_t)(r0 + r) * d + c]) * mul;
    dst[r * (DT + 1) + c] = x;
  }
}

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

template <typename T, int DT>
__global__ void __launch_bounds__(kThreads) ring_flash_attn_kernel(
    const Args a) {
  constexpr int kStride = DT + 1;
  constexpr int kDCols = DT / 16;       // output columns of a thread
  extern __shared__ float smem[];
  float* sq = smem;                     // [kBQ][kStride]: q · scale
  float* skv = sq + kBQ * kStride;      // [kBK][kStride]: K, then V
  float* sp = skv + kBK * kStride;      // [kBQ][kPStride]: p

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n = a.n, s = a.s, d = a.d;
  // the ranks and query tiles with the most causal work are dispatched first
  const int me = n - 1 - (int)blockIdx.z;
  const int q0 = ((int)gridDim.x - 1 - (int)blockIdx.x) * kBQ;
  const int head = blockIdx.y;
  const int kvh = head / (a.h / a.h_kv);
  const size_t q_off = (size_t)head * s * d;
  const size_t kv_off = (size_t)kvh * s * d;

  load_tile<T, DT, kBQ>(sq, static_cast<const T*>(a.q[me]) + q_off, q0, s,
                        d, a.scale);

  float m[kRows], l[kRows], acc[kRows][kDCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDCols; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n; ++t) {
    const int src = (me - t + n) % n;
    if (a.causal && src > me) continue;          // wholly masked: exact skip
    const T* kb = static_cast<const T*>(a.k[src]) + kv_off;
    const T* vb = static_cast<const T*>(a.v[src]) + kv_off;
    // in the diagonal block, tiles after the CTA's last query: exact skip
    const int j_end = (a.causal && src == me) ? min(s, q0 + kBQ) : s;
    const long long q_base = (long long)me * s, k_base = (long long)src * s;
    for (int j0 = 0; j0 < j_end; j0 += kBK) {
      __syncthreads();                // the last tile's P and V are read
      load_tile<T, DT, kBK>(skv, kb, j0, s, d, 1.f);
      __syncthreads();

      float sc[kRows][kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) sc[i][j] = 0.f;
      for (int c = 0; c < d; ++c) {
        float qv[kRows], kv[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          qv[i] = sq[(ty + 16 * i) * kStride + c];
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          kv[j] = skv[(tx + 16 * j) * kStride + c];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
      }

#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const long long qpos = q_base + q0 + ty + 16 * i;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int kj = j0 + tx + 16 * j;
          if (kj >= s || (a.causal && qpos < k_base + kj))
            sc[i][j] = -INFINITY;
          mx = fmaxf(mx, sc[i][j]);
        }
        const float m_new = fmaxf(m[i], row_max(mx));
        // exp(-inf - -inf) would be NaN; fully masked rows keep p = 0
        const float safe_m = isfinite(m_new) ? m_new : 0.f;
        const float corr = isfinite(m[i]) ? expf(m[i] - safe_m) : 0.f;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const float p =
              isfinite(sc[i][j]) ? expf(sc[i][j] - safe_m) : 0.f;
          sp[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
          rs += p;
        }
        l[i] = l[i] * corr + row_sum(rs);
#pragma unroll
        for (int c = 0; c < kDCols; ++c) acc[i][c] *= corr;
        m[i] = m_new;
      }

      __syncthreads();                // K is read, P is written
      load_tile<T, DT, kBK>(skv, vb, j0, s, d, 1.f);
      __syncthreads();
      const int jn = min(kBK, s - j0);
      for (int j = 0; j < jn; ++j) {
        float pv[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          pv[i] = sp[(ty + 16 * i) * kPStride + j];
#pragma unroll
        for (int c = 0; c < kDCols; ++c) {
          const float vv = skv[j * kStride + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }

  T* o = static_cast<T*>(a.o[me]) + q_off;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s) continue;
    const float den = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < kDCols; ++c) {
      const int col = tx + 16 * c;
      if (col < d) o[(size_t)row * d + col] = from_f32<T>(acc[i][c] / den);
    }
  }
}

template <typename T, int DT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(DT);
  cudaError_t e = cudaFuncSetAttribute(
      ring_flash_attn_kernel<T, DT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.s + kBQ - 1) / kBQ, a.h, a.n);
  ring_flash_attn_kernel<T, DT><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_dim(const Args& a, cudaStream_t stream) {
  if (a.d <= 16) return launch<T, 16>(a, stream);
  if (a.d <= 32) return launch<T, 32>(a, stream);
  if (a.d <= 64) return launch<T, 64>(a, stream);
  if (a.d <= 128) return launch<T, 128>(a, stream);
  return launch<T, 256>(a, stream);
}

}  // namespace

extern "C" {

// Ring attention of n ranks on `stream`. `ptrs` is a host array of 4n
// device pointers: q of every rank, then k, v and o. dtype code
// (kernels/ring_attention.py:DTYPE_CODES): 0 float, 1 half, 2 bfloat16.
// Returns the launch's CUDA error (0 when it was queued).
int ucc_ring_flash_attn(int dtype, const void* const* ptrs, int n, int h,
                        int h_kv, int s, int d, float scale, int causal,
                        void* stream) {
  if (n < 1 || n > kMaxRanks || h_kv < 1 || h < h_kv || h % h_kv != 0 ||
      h > 65535 || s < 1 || d < 1 || d > 256)
    return cudaErrorInvalidValue;
  Args a = {};
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
    case 0: return by_dim<float>(a, st);
    case 1: return by_dim<__half>(a, st);
    case 2: return by_dim<__nv_bfloat16>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* ucc_ring_flash_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
