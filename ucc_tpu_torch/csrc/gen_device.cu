// Generated device collectives with wire layers: a lowered DSL program
// over the n ranks of one GPU, layer by layer, as one kernel launch.
//
// Replaces ucc_tpu/dsl/lower_device.py:_build_pallas_device_program's
// gen_kernel for the plans that have a wire layer (an edge tagged int8 or
// fp8). Every exact plan, rings included, runs gen_fold.cu instead: one
// flag-free pass that evaluates each unit's expression (kernels/
// gen_device.py:fold_plan). The plan's tables come from ucc_tpu_torch/dsl/
// lower_device.py:device_plan; kernels/gen_device.py holds the wrappers and
// the plain PyTorch version, which follows the same steps with the same
// rounding, so the two agree bitwise.
//
// A cooperative launch on a (lanes, n) grid: CTA (c, r) plays lane c of
// rank r. An instruction list, each entry one phase over all ranks, with a
// grid-wide barrier after each, since a later phase may read what any CTA
// of any rank wrote before (the lanes of a rank split each run, and the
// runs of consecutive layers need not line up):
//   exact layer: receiver q folds the run of its sender p = src[q], read
//     straight from p's buffer (within a round no rank writes a chunk it
//     sends, so the run is what p held when the layer began);
//   wire send: the sender quantizes its run per qblock (one qblock per CTA
//     at a time, its absmax one block reduction), writes the int8 or fp8
//     payload and the float32 scales into the receiver's single-use arena
//     slot, and its own decoded copy back into its run;
//   wire receive: the receiver adds q * scale in float32;
//   copy: one chunk to another within a rank.
// Unlike the Pallas kernel, exact layers need no arena: every rank's
// buffer is in this card's memory.
// AVG is SUM, then one multiply by dtype(1/n) (alpha), as in the Pallas
// kernel. The wire arithmetic is unfused and in round-to-nearest: the
// scale is amax times float32(1/QMAX) (the Pallas kernel divides by the
// constant QMAX, which its compiler turns into that multiply: its results
// are bitwise this), __fdiv_rn for the division by the scale, rintf (half
// to even) then a clip for int8, a clip then __nv_cvt_float_to_fp8 (round
// to nearest even, saturating) for fp8, __fmul_rn then __fadd_rn for the
// decode.
//
// What bounds it: bytes. An allreduce must read n*S and write n*S bytes
// for S bytes per rank (2*n*S at 3.35 TB/s on an H100 SXM). The program
// moves more: every layer reads the sender's run and reads and writes the
// receiver's, and the src->dst copy adds 2*S per rank. This first version
// is plain: scalar loads and stores, one qblock per CTA at a time, one grid
// barrier per phase.

#include "ring_common.cuh"

#include <cuda_fp8.h>

namespace {

constexpr int K_GEN = 0;

// instruction kinds and layout of kernels/gen_device.py
constexpr int I_EXACT = 0;
constexpr int I_WSEND = 1;
constexpr int I_WRECV = 2;
constexpr int I_COPY = 3;
constexpr int INSTR_WORDS = 8;
constexpr int TAB_ROWS = 6;  // send off, has_send, recv off, has_recv, dst, src

constexpr int Q_INT8 = 1;
constexpr int Q_FP8 = 2;

struct GenArgs {
  void* const* ptrs;      // device array: n src pointers, then n dst
  void* comm;             // n x arena
  unsigned* flags;        // the grid barrier's counter
  int* err;               // sticky error word
  const int* tab;         // (6 layers, n)
  const long long* prog;  // instructions
  const int* ctab;        // (3 copies, n)
  long long count;        // elements per rank
  long long arena;        // wire arena bytes per rank
  int n_items;            // instructions
  int n;
  int op;
  int avg;                // multiply by alpha at the end
  double alpha;           // dtype(1/n), exact in T
  int qmode;
  int qblock;
};

__device__ float fp8_to_float(unsigned char b) {
  __half_raw h = __nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)b, __NV_E4M3);
  return __half2float(__half(h));
}

// Every CTA of the grid arrives, then waits for all of them: `epoch` counts
// the barriers of this launch, and the counter (zeroed by the launch)
// reaches epoch * CTAs. Every thread returns false when a spin ran out.
__device__ bool grid_sync(unsigned* counter, unsigned& epoch, int* err,
                          volatile int* abort_flag) {
  ++epoch;
  const unsigned total = gridDim.x * gridDim.y;
  __syncthreads();  // every thread's stores of the phase are issued
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    spin_geq(counter, epoch * total, err, abort_flag);
    __threadfence();
  }
  __syncthreads();
  return *abort_flag == 0;
}

// The largest |value| over the CTA; every thread gets it.
__device__ float block_absmax(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // red[] of the previous call is read
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float m = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) m = fmaxf(m, red[w]);
  return m;
}

// ---------------------------------------------------------------------
// layer entry

template <typename T>
__device__ void wire_send(const GenArgs& a, const long long* ins,
                          const int* row, float* red, float* s_scale) {
  const int n = a.n;
  const int r = blockIdx.y;
  const long long L = ins[2];
  const long long wl = ins[6];
  const int B = a.qblock;
  const float qmax = a.qmode == Q_INT8 ? 127.f : 448.f;
  const float inv_qmax = __fdiv_rn(1.f, qmax);
  T* x = static_cast<T*>(a.ptrs[n + r]) + row[0 * n + r];
  unsigned char* arena = static_cast<unsigned char*>(a.comm) +
                         (size_t)row[4 * n + r] * a.arena;
  unsigned char* qout = arena + ins[4];
  float* sout = reinterpret_cast<float*>(arena + ins[5]);
  for (long long j = blockIdx.x; j * B < wl; j += gridDim.x) {
    float m = 0.f;
    for (int e = threadIdx.x; e < B; e += blockDim.x) {
      const long long g = j * B + e;
      if (g < L) m = fmaxf(m, fabsf(Elem<T>::tof(load_slot(x + g))));
    }
    m = block_absmax(m, red);
    if (threadIdx.x == 0) {
      *s_scale = m > 0.f ? __fmul_rn(m, inv_qmax) : 1.f;
      store_slot(sout + j, *s_scale);
    }
    __syncthreads();
    const float scale = *s_scale;
    for (int e = threadIdx.x; e < B; e += blockDim.x) {
      const long long g = j * B + e;
      const float v = g < L ? Elem<T>::tof(load_slot(x + g)) : 0.f;
      const float s = __fdiv_rn(v, scale);
      unsigned char qb;
      float qf;
      if (a.qmode == Q_INT8) {
        const float rv = fminf(fmaxf(rintf(s), -127.f), 127.f);
        const signed char qi = (signed char)(int)rv;
        qb = (unsigned char)qi;
        qf = (float)qi;
      } else {
        qb = (unsigned char)__nv_cvt_float_to_fp8(
            fminf(fmaxf(s, -448.f), 448.f), __NV_SATFINITE, __NV_E4M3);
        qf = fp8_to_float(qb);
      }
      __stcg(qout + g, qb);
      if (g < L) store_slot(x + g, from_float<T>(__fmul_rn(qf, scale)));
    }
    __syncthreads();  // s_scale is rewritten by the next block
  }
}

template <typename T>
__device__ void wire_recv(const GenArgs& a, const long long* ins,
                          const int* row) {
  const int n = a.n;
  const int r = blockIdx.y;
  const long long L = ins[2];
  const bool reduce = ins[3] != 0;
  const int B = a.qblock;
  T* out = static_cast<T*>(a.ptrs[n + r]) + row[2 * n + r];
  const unsigned char* arena =
      static_cast<const unsigned char*>(a.comm) + (size_t)r * a.arena;
  const unsigned char* qin = arena + ins[4];
  const float* sin = reinterpret_cast<const float*>(arena + ins[5]);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < L; i += stride) {
    const unsigned char qb = __ldcg(qin + i);
    const float qf = a.qmode == Q_INT8 ? (float)(signed char)qb
                                       : fp8_to_float(qb);
    const float inc = __fmul_rn(qf, __ldcg(sin + i / B));
    const float v = reduce
        ? __fadd_rn(Elem<T>::tof(load_slot(out + i)), inc) : inc;
    store_slot(out + i, from_float<T>(v));
  }
}

template <typename T>
__device__ void gen_entry(const GenArgs& a) {
  __shared__ int abort_flag;
  __shared__ float red[32];
  __shared__ float s_scale;
  const int n = a.n;
  const int r = blockIdx.y;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const T* src = static_cast<const T*>(a.ptrs[r]);
  T* work = static_cast<T*>(a.ptrs[n + r]);
  unsigned epoch = 0;

  if (threadIdx.x == 0) abort_flag = 0;
  if (src != work)
    for (long long i = first; i < a.count; i += stride)
      store_slot(work + i, src[i]);
  if (!grid_sync(a.flags, epoch, a.err, &abort_flag)) return;

  for (int k = 0; k < a.n_items; ++k) {
    const long long* ins = a.prog + (size_t)k * INSTR_WORDS;
    const int kind = (int)ins[0];
    const long long li = ins[1];
    const long long L = ins[2];
    const int* row = a.tab + (size_t)li * TAB_ROWS * n;
    if (kind == I_EXACT) {
      if (row[3 * n + r]) {
        const int p = row[5 * n + r];
        const T* in = static_cast<const T*>(a.ptrs[n + p]) + row[0 * n + p];
        T* out = work + row[2 * n + r];
        const bool reduce = ins[3] != 0;
        for (long long i = first; i < L; i += stride) {
          const T v = load_slot(in + i);
          store_slot(out + i,
                     reduce ? accumulate(a.op, load_slot(out + i), v) : v);
        }
      }
    } else if (kind == I_WSEND) {
      if (row[1 * n + r]) wire_send<T>(a, ins, row, red, &s_scale);
    } else if (kind == I_WRECV) {
      if (row[3 * n + r]) wire_recv<T>(a, ins, row);
    } else {
      const int* crow = a.ctab + (size_t)li * 3 * n;
      if (crow[2 * n + r]) {
        const T* in = work + crow[0 * n + r];
        T* out = work + crow[1 * n + r];
        for (long long i = first; i < L; i += stride)
          store_slot(out + i, load_slot(in + i));
      }
    }
    if (!grid_sync(a.flags, epoch, a.err, &abort_flag)) return;
  }

  if (a.avg) {
    const T inv = from_double<T>(a.alpha);
    for (long long i = first; i < a.count; i += stride)
      store_slot(work + i, Elem<T>::mul(load_slot(work + i), inv));
  }
}

template <typename T>
__global__ void gen_device_gen_kernel(GenArgs a) {
  gen_entry<T>(a);
}

const void* select_kernel(int kernel, int dtype) {
  if (kernel != K_GEN) return nullptr;
  switch (dtype) {
    case DT_F32: return (const void*)gen_device_gen_kernel<float>;
    case DT_F16: return (const void*)gen_device_gen_kernel<__half>;
    case DT_BF16: return (const void*)gen_device_gen_kernel<__nv_bfloat16>;
    case DT_I32: return (const void*)gen_device_gen_kernel<int>;
    case DT_I64: return (const void*)gen_device_gen_kernel<long long>;
    case DT_I8: return (const void*)gen_device_gen_kernel<signed char>;
    case DT_U8: return (const void*)gen_device_gen_kernel<unsigned char>;
    case DT_I16: return (const void*)gen_device_gen_kernel<short>;
    case DT_F64: return (const void*)gen_device_gen_kernel<double>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Most CTAs of `threads` threads that can be resident at once for the
// layer kernel (SMs x blocks per SM): the bound on n x lanes.
int ucc_gen_device_max_ctas(int kernel, int dtype, int threads, int* out) {
  const void* kern = select_kernel(kernel, dtype);
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

// Launch one generated collective with wire layers on `stream`; returns
// cudaGetLastError() after the launch (0 on success).
int ucc_gen_device(int kernel, int dtype, void* const* ptrs, void* comm,
                   unsigned* flags, int* err, const int* tab,
                   const long long* prog, const int* ctab, long long count,
                   long long arena, int n_items, int n, int op,
                   int avg, double alpha, int qmode, int qblock, int lanes,
                   int threads, cudaStream_t stream) {
  const void* kern = select_kernel(kernel, dtype);
  if (kern == nullptr || n < 1 || (qmode != 0 && qblock < 1))
    return (int)cudaErrorInvalidValue;
  GenArgs a{ptrs, comm, flags, err, tab, prog, ctab, count, arena, n_items,
            n, op, avg, alpha, qmode, qblock};
  void* params[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(kern, dim3(lanes, n),
                                              dim3(threads), params, 0,
                                              stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* ucc_gen_device_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
