// Generated device collectives with wire layers: a lowered DSL program
// over the n ranks of one GPU whose edges carry int8 or fp8, as one kernel
// launch.
//
// Replaces ucc_tpu/dsl/lower_device.py:_build_pallas_device_program's
// gen_kernel (:595) for the plans that have a wire layer. Every exact plan,
// rings included, runs gen_fold.cu instead. The plan's tables come from
// ucc_tpu_torch/dsl/lower_device.py:device_plan; kernels/gen_device.py
// holds the wrappers and the plain PyTorch versions, which follow the same
// steps with the same rounding, so all of them agree bitwise. Two kernels,
// chosen on the host from the plan alone (kernels/gen_device.py:fold_plan):
//
// 1. The wire fold (gen_wire_fold_kernel), for every wire plan that has a
//    fold plan: one ordinary launch, no workspace, arena, flags, error word
//    or grid barrier. fold_plan runs the plan on symbolic units, as for
//    exact plans, with two more operations: QDQ (a wire send: the value
//    quantized per qblock group and decoded, the groups counted from the
//    unit's start) and a float32 add (a wire receive that reduces, the
//    receiver's value first). When every wire run is one unit long, or the
//    unit is a multiple of qblock, every qblock group lies inside one unit,
//    and every rank's unit ends as an expression over that unit of the
//    srcs. A wire plan's ranks do not all end alike: each gather layer
//    re-quantizes the sender's decoded copy, and QDQ is not idempotent. On
//    the plans this serves, a unit's expressions lie on one chain R, QDQ(R),
//    QDQ^2(R), ..., so one program per unit evaluates the deepest and
//    STOREs the top into rank r's dst at the step where the top is rank r's
//    expression. Steps (kernels/gen_device.py: S_*):
//      LOAD, FOLD_L, FOLD_R, COMB, COMB_SWAP   as gen_fold.cu (acc of op)
//      QDQ         top = QDQ(top) over the group
//      WADD        pop below; top = below + top (float32, round to nearest)
//      WADD_SWAP   pop below; top = top + below
//      STORE       top (times AVG's factor) into the next store rank's dst
//    One warp takes one qblock group (qblock <= WIRE_MAX_QBLOCK = 256, at
//    most 8 values a lane) of one unit at a time, grid-stride over the
//    groups of all units. It issues the loads of WIRE_LEAVES leaves (the
//    srcs at the group) before the steps that take them, and fetches each
//    step kind one step ahead; the top of the stack lives in registers,
//    the STACK - 1 values below it in the warp's slots of shared memory
//    (a combine reads its operand from there value by value); the group's
//    absmax is a __shfl_xor_sync butterfly, with no __syncthreads. The
//    chain of QDQs is serial within a warp, so what hides it is warps: CTAs
//    of WIRE_THREADS = 128 with registers capped for WIRE_MIN_BLOCKS = 5 of
//    them an SM (20 warps; 96 registers at 8 values a lane, no spill), two
//    leaf loads in flight a warp (tools/wire_fold_cuts.py times the
//    alternatives; PERF.md has the numbers).
//    Lanes past the end of a partial group (the unit's last one, padded
//    with zeros by the reference) load 0, count 0 in the absmax and store
//    nothing. A group takes 16-byte vectors (lane l holds elements
//    128 s + 4 l .. + 3) when every one of the 2n pointers lies at one offset
//    mod 16 (direct_fold.cuh's stage_table), the group starts on a 16-byte
//    boundary and its length is a multiple of 4; else scalar loads (lane l
//    holds elements 32 s + l). In place is safe: the host puts every STORE
//    after the program's last leaf step, so a group reads every src element
//    of its elements before it writes any dst element, and no other warp
//    touches them. Instances: float32 only (wire layers take float32), by
//    wire type (int8, fp8) and values a lane (1, 2, 4, 8); the op of COMB
//    steps is a launch argument (AVG folds as SUM, with one multiply by
//    float32(1/n) at each STORE). Across processes of one host
//    (tl/device_sync.py) each process walks one part [glo, ghi) of the
//    groups of all units: whole groups, since a group's scale is taken
//    over the whole group, so the union of the parts is bitwise the single
//    launch; the whole walk is [0, count / unit x groups).
//
// 2. The layer kernel (gen_device_gen_kernel), for the wire plans that
//    have no fold plan: qblock above 256, a wire run longer than a unit
//    that is no multiple of qblock (its groups straddle units), a program
//    deeper than the stack, or a rank whose expression is no top of its
//    unit's program. A cooperative launch on a (lanes, n) grid: CTA (c, r)
//    plays lane c of rank r. An instruction list, each entry one phase
//    over all ranks, with a grid-wide barrier after each, since a later
//    phase may read what any CTA of any rank wrote before (the lanes of a
//    rank split each run, and the runs of consecutive layers need not line
//    up):
//      exact layer: receiver q folds the run of its sender p = src[q], read
//        straight from p's buffer (within a round no rank writes a chunk it
//        sends, so the run is what p held when the layer began);
//      wire send: the sender quantizes its run per qblock (one qblock per
//        CTA at a time, its absmax one block reduction), writes the int8 or
//        fp8 payload and the float32 scales into the receiver's single-use
//        arena slot, and its own decoded copy back into its run;
//      wire receive: the receiver adds q * scale in float32;
//      copy: one chunk to another within a rank.
//    A spin that runs out sets the workspace's error word. AVG is SUM, then
//    one multiply by dtype(1/n) (alpha), as in the Pallas kernel. Its grid
//    barrier and its arena in the launching process's workspace cannot be
//    cut across the launches of several processes: on a team across
//    processes, process 0 launches the whole walk over the peers' buffers
//    and the others launch nothing (kernels/gen_device.py: part_walk).
//
// The wire arithmetic, shared by both kernels (group_scale, wire_code):
// unfused and in round-to-nearest, the scale is amax times float32(1/QMAX)
// (the Pallas kernel divides by the constant QMAX, which its compiler turns
// into that multiply: its results are bitwise this), __fdiv_rn for the
// division by the scale (a multiply by the reciprocal would not be
// bitwise), rintf (half to even) then a clip for int8 (computed as
// s + 1.5 x 2^23 - 1.5 x 2^23, which is bitwise that), a clip then
// __nv_cvt_float_to_fp8 (round to nearest even, saturating) for fp8,
// __fmul_rn then __fadd_rn for the decode. The library is built without
// --use_fast_math.
//
// What bounds it: bytes. An allreduce must read n*S and write n*S bytes
// for S bytes per rank (0.3205 ms at 3.35 TB/s for 8 ranks of 64 MiB); the
// wire fold moves exactly that. Its arithmetic is heavier than an exact
// fold's: at the edge-wired direct exchange of 8 ranks, 14 QDQs per result
// element (7 in the reduce round, 7 chained in the gather round), each an
// IEEE division, a rounding and conversions, about 0.1-0.3 ms of the
// card's issue rate if none of it hid behind the loads. The layer kernel
// moves far more: every layer reads the sender's run twice, writes its
// decoded copy back, writes the payload into the arena and reads it back,
// and reads and writes the receiver's run; and it stops at a grid barrier
// after every phase. Across GPUs (ROADMAP A5) a fold reads the peers'
// full-precision srcs, so the wire's byte saving returns only with a
// payload that crosses the link, as the layer kernel's arena does: the
// layer kernel is that path's starting point.

#include "direct_fold.cuh"

#include <cuda_fp8.h>

namespace {

// kernel numbers of the occupancy query: the layer kernel, then the wire
// fold's instances from WIRE_KERNELS (kernels/gen_device.py: K_GEN,
// wire_kernel)
constexpr int K_GEN = 0;
constexpr int WIRE_KERNELS = 1;

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

__device__ __forceinline__ float fp8_to_float(unsigned char b) {
  __half_raw h = __nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)b, __NV_E4M3);
  return __half2float(__half(h));
}

// float32(1 / QMAX) of a wire type
__device__ __forceinline__ float inv_qmax(int qmode) {
  return __fdiv_rn(1.f, qmode == Q_INT8 ? 127.f : 448.f);
}

// The scale of a qblock group whose largest |value| is amax.
__device__ __forceinline__ float group_scale(float amax, float inv) {
  return amax > 0.f ? __fmul_rn(amax, inv) : 1.f;
}

// The quotient s = v / scale on the wire: its byte into qb, its value as
// a float returned. int8: rintf (half to even) then a clip to +-127, the
// value as the int8 payload has it (a zero is +0): the rounding adds and
// subtracts 1.5 x 2^23, which rounds |s| < 2^22 to an integer half to even
// and gives +0 for a zero, and any larger |s| (or a NaN) clips to the same
// +-127 as rintf would, so the value is bitwise (float)(int8)rintf(s)
// clipped, without a conversion instruction. fp8: a clip to +-448, then
// __nv_cvt_float_to_fp8 (round to nearest even, saturating) and back.
template <int QMODE>
__device__ __forceinline__ float wire_code(float s, unsigned char& qb) {
  if (QMODE == Q_INT8) {
    const float r = __fadd_rn(__fadd_rn(s, 12582912.f), -12582912.f);
    const float qf = fminf(fmaxf(r, -127.f), 127.f);
    qb = (unsigned char)(signed char)(int)qf;
    return qf;
  }
  qb = (unsigned char)__nv_cvt_float_to_fp8(fminf(fmaxf(s, -448.f), 448.f),
                                            __NV_SATFINITE, __NV_E4M3);
  return fp8_to_float(qb);
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
  const float inv = inv_qmax(a.qmode);
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
      *s_scale = group_scale(m, inv);
      store_slot(sout + j, *s_scale);
    }
    __syncthreads();
    const float scale = *s_scale;
    for (int e = threadIdx.x; e < B; e += blockDim.x) {
      const long long g = j * B + e;
      const float v = g < L ? Elem<T>::tof(load_slot(x + g)) : 0.f;
      const float s = __fdiv_rn(v, scale);
      unsigned char qb;
      const float qf = a.qmode == Q_INT8 ? wire_code<Q_INT8>(s, qb)
                                         : wire_code<Q_FP8>(s, qb);
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

// ---------------------------------------------------------------------
// the wire fold

// step kinds of kernels/gen_device.py (S_*) and a program's header
constexpr int S_LOAD = 0;
constexpr int S_FOLD_L = 1;  // then S_FOLD_R = 2
constexpr int S_COMB = 3;
constexpr int S_COMB_SWAP = 4;
constexpr int S_QDQ = 5;
constexpr int S_WADD = 6;  // then S_WADD_SWAP = 7
constexpr int S_STORE = 8;
constexpr int HEADER = 3;  // steps, leaves, stores
constexpr int STACK = 5;   // values a program holds at once (FOLD_STACK)
// widest group: one warp, WIRE_MAX_QBLOCK / 32 values a lane
constexpr int WIRE_MAX_QBLOCK = 256;
// leaf loads a warp issues together, before the steps that take them
constexpr int WIRE_LEAVES = 2;
// threads of a CTA (kernels/gen_device.py: WIRE_THREADS), and the CTAs an
// SM must hold (registers capped to fit them)
constexpr int WIRE_THREADS = 128;
constexpr int WIRE_MIN_BLOCKS = 5;
constexpr int WARP = 32;

struct WireArgs {
  void* const* ptrs;  // device array: n src pointers, then n dst
  const int* units;   // per unit: its program's offset in `code`
  const int* code;    // programs: header, leaf ranks, store ranks, steps
  long long count;    // elements per rank
  long long unit;     // elements per unit
  long long groups;   // qblock groups per unit
  long long glo, ghi; // the part of all units' groups this launch walks
  int qblock;
  int n;
  int op;             // of COMB steps
  int avg;            // multiply by alpha at each STORE
  float alpha;        // float32(1/n)
};

// A lane's V values of one group: slot s is element 128 (s / 4) + 4 lane +
// s % 4 of the group on the vector path, 32 s + lane on the scalar one.
template <int V>
struct Vals {
  float v[V];
};

template <int V, bool VEC>
__device__ __forceinline__ int slot_elem(int s, int lane) {
  return VEC ? 128 * (s / 4) + 4 * lane + s % 4 : WARP * s + lane;
}

// The group's elements of one buffer; 0 past its end.
template <int V, bool VEC>
__device__ __forceinline__ void load_group(Vals<V>& x, const float* p,
                                           int lane, int len) {
  if constexpr (VEC) {
#pragma unroll
    for (int s = 0; s < V; s += 4) {
      const int i = slot_elem<V, VEC>(s, lane);
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < len) f = __ldcs(reinterpret_cast<const float4*>(p + i));
      x.v[s] = f.x;
      x.v[s + 1] = f.y;
      x.v[s + 2] = f.z;
      x.v[s + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int s = 0; s < V; ++s) {
      const int i = slot_elem<V, VEC>(s, lane);
      x.v[s] = i < len ? __ldcs(p + i) : 0.f;
    }
  }
}

// The group's live elements into one buffer, times alpha when `avg`.
template <int V, bool VEC>
__device__ __forceinline__ void store_group(float* p, const Vals<V>& x,
                                            int lane, int len, int avg,
                                            float alpha) {
  Vals<V> y = x;
  if (avg) {
#pragma unroll
    for (int s = 0; s < V; ++s) y.v[s] = __fmul_rn(x.v[s], alpha);
  }
  if constexpr (VEC) {
#pragma unroll
    for (int s = 0; s < V; s += 4) {
      const int i = slot_elem<V, VEC>(s, lane);
      if (i < len)
        __stcs(reinterpret_cast<float4*>(p + i),
               make_float4(y.v[s], y.v[s + 1], y.v[s + 2], y.v[s + 3]));
    }
  } else {
#pragma unroll
    for (int s = 0; s < V; ++s) {
      const int i = slot_elem<V, VEC>(s, lane);
      if (i < len) __stcs(p + i, y.v[s]);
    }
  }
}

// top = QDQ(top): the group's absmax over its live elements (a butterfly
// over the warp), its scale, each value quantized and decoded.
template <int QMODE, int V, bool VEC>
__device__ __forceinline__ void qdq(Vals<V>& top, int lane, int len) {
  float m = 0.f;
#pragma unroll
  for (int s = 0; s < V; ++s)
    if (slot_elem<V, VEC>(s, lane) < len) m = fmaxf(m, fabsf(top.v[s]));
#pragma unroll
  for (int o = WARP / 2; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float scale = group_scale(m, inv_qmax(QMODE));
#pragma unroll
  for (int s = 0; s < V; ++s) {
    unsigned char qb;
    const float code = wire_code<QMODE>(__fdiv_rn(top.v[s], scale), qb);
    top.v[s] = __fmul_rn(code, scale);
  }
}

// The values below the top: STACK - 1 slots of a warp in shared memory,
// value s of slot j of lane l at [j][s][l] (a warp's accesses hit 32
// banks); a combine reads its operand from there value by value.
template <int V>
struct Below {
  float (*slot)[V][WARP];
  __device__ __forceinline__ void push(int j, const Vals<V>& x,
                                       int lane) const {
#pragma unroll
    for (int s = 0; s < V; ++s) slot[j][s][lane] = x.v[s];
  }
};

// The program's next step kind, the one after it already on its way (the
// code ends in a padding word).
struct Steps {
  const int* kind;
  int k;
  int next;
  __device__ __forceinline__ int take() {
    const int s = next;
    next = __ldg(kind + ++k);
    return s;
  }
};

// One step that takes no leaf: COMB, COMB_SWAP, QDQ, WADD, WADD_SWAP or
// STORE. `rank` is the next STORE's rank, the one after it fetched as it
// is taken (past the last store rank lies the first step kind).
template <int QMODE, int V, bool VEC>
__device__ __forceinline__ void wire_step(
    const Table& t, const WireArgs& a, const int* store_rank, int kind,
    Vals<V>& top, const Below<V>& below, int& sp, int& st, int& rank,
    long long e0, int lane, int len) {
  if (kind == S_QDQ) {
    qdq<QMODE, V, VEC>(top, lane, len);
    return;
  }
  if (kind == S_STORE) {
    float* dst = t.dst<float>(rank) + e0;
    rank = __ldg(store_rank + ++st);
    store_group<V, VEC>(dst, top, lane, len, a.avg, a.alpha);
    return;
  }
  // a combine: pop the value below the top, read value by value
  const float(*b)[WARP] = below.slot[--sp];
  if (kind >= S_WADD) {
#pragma unroll
    for (int s = 0; s < V; ++s)
      top.v[s] = kind == S_WADD ? __fadd_rn(b[s][lane], top.v[s])
                                : __fadd_rn(top.v[s], b[s][lane]);
  } else {
#pragma unroll
    for (int s = 0; s < V; ++s)
      top.v[s] = kind == S_COMB ? accumulate(a.op, b[s][lane], top.v[s])
                                : accumulate(a.op, top.v[s], b[s][lane]);
  }
}

// Unit q's program over the group of `len` elements at element e0.
template <int QMODE, int V, bool VEC>
__device__ void wire_group(const Table& t, const WireArgs& a,
                           const Below<V>& below, long long q, long long e0,
                           int len, int lane) {
  const int* prog = a.code + __ldg(a.units + q);
  const int leaves = __ldg(prog + 1);
  const int* leaf = prog + HEADER;
  const int* store_rank = leaf + leaves;
  Steps steps{store_rank + __ldg(prog + 2), 0, 0};
  steps.next = __ldg(steps.kind);
  const int n_steps = __ldg(prog);
  int rank = __ldg(store_rank);
  Vals<V> top;
  int sp = 0;  // values below the top
  int st = 0;  // the next store rank
  for (int base = 0; base < leaves; base += WIRE_LEAVES) {
    Vals<V> x[WIRE_LEAVES];
#pragma unroll
    for (int i = 0; i < WIRE_LEAVES; ++i)
      if (base + i < leaves)
        load_group<V, VEC>(x[i], t.src<float>(__ldg(leaf + base + i)) + e0,
                           lane, len);
#pragma unroll
    for (int i = 0; i < WIRE_LEAVES; ++i) {
      if (base + i >= leaves) break;
      int s = steps.take();
      while (s >= S_COMB) {  // the steps before the next leaf's
        wire_step<QMODE, V, VEC>(t, a, store_rank, s, top, below, sp, st,
                                 rank, e0, lane, len);
        s = steps.take();
      }
      if (s == S_LOAD) {
        if (steps.k > 1) below.push(sp++, top, lane);  // not the first step
        top = x[i];
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e)
          top.v[e] = s == S_FOLD_L ? accumulate(a.op, x[i].v[e], top.v[e])
                                   : accumulate(a.op, top.v[e], x[i].v[e]);
      }
    }
  }
  while (steps.k < n_steps)
    wire_step<QMODE, V, VEC>(t, a, store_rank, steps.take(), top, below, sp,
                             st, rank, e0, lane, len);
}

template <int QMODE, int V>
__global__ void __launch_bounds__(WIRE_THREADS, WIRE_MIN_BLOCKS)
    gen_wire_fold_kernel(WireArgs a) {
  __shared__ void* staged[2 * SMEM_RANKS];
  __shared__ float stack[WIRE_THREADS / WARP][STACK - 1][V][WARP];
  bool aligned;
  long long head;
  const Table t = stage_table<float>(a.ptrs, a.n, staged, a.count, aligned,
                                     head);
  const int lane = threadIdx.x % WARP;
  const Below<V> below{stack[threadIdx.x / WARP]};
  const long long warps = (long long)gridDim.x * blockDim.x / WARP;
  for (long long g = a.glo + ((long long)blockIdx.x * blockDim.x +
                              threadIdx.x) / WARP;
       g < a.ghi; g += warps) {
    const long long q = g / a.groups;
    const long long k = g - q * a.groups;
    const long long e0 = q * a.unit + k * a.qblock;
    const int len = (int)min((long long)a.qblock, a.unit - k * a.qblock);
    // 16-byte vectors: V a multiple of 4, every pointer at one offset mod
    // 16, the group on a 16-byte boundary and whole vectors long
    if (V % 4 == 0 && aligned && ((e0 - head) & 3) == 0 && (len & 3) == 0)
      wire_group<QMODE, V, V % 4 == 0>(t, a, below, q, e0, len, lane);
    else
      wire_group<QMODE, V, false>(t, a, below, q, e0, len, lane);
  }
}

// The wire fold's instance of kernel number `kernel` (WIRE_KERNELS + 4 x
// (qmode - 1) + log2 of the values a lane), or nullptr.
const void* select_wire(int kernel) {
  switch (kernel - WIRE_KERNELS) {
    case 0: return (const void*)gen_wire_fold_kernel<Q_INT8, 1>;
    case 1: return (const void*)gen_wire_fold_kernel<Q_INT8, 2>;
    case 2: return (const void*)gen_wire_fold_kernel<Q_INT8, 4>;
    case 3: return (const void*)gen_wire_fold_kernel<Q_INT8, 8>;
    case 4: return (const void*)gen_wire_fold_kernel<Q_FP8, 1>;
    case 5: return (const void*)gen_wire_fold_kernel<Q_FP8, 2>;
    case 6: return (const void*)gen_wire_fold_kernel<Q_FP8, 4>;
    case 7: return (const void*)gen_wire_fold_kernel<Q_FP8, 8>;
    default: return nullptr;
  }
}

const void* select_kernel(int kernel, int dtype) {
  if (kernel >= WIRE_KERNELS)
    return dtype == DT_F32 ? select_wire(kernel) : nullptr;
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

// Most CTAs of `threads` threads that can be resident at once for kernel
// number `kernel` (SMs x blocks per SM): for the layer kernel the bound on
// n x lanes, for the wire fold the grid.
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

// Launch the wire fold of one generated collective on `stream`: instance
// `kernel` (its values a lane cover `qblock`), `units` and `code` the fold
// plan's tables on the device, `op` the fold of COMB steps, `avg` whether
// each STORE multiplies by `alpha`, on a grid of `ctas` CTAs of `threads`
// threads, walking groups [glo, ghi) of all units' groups (a team across
// processes launches one part in each process). Returns cudaGetLastError()
// after the launch (0 on success).
int ucc_gen_wire_fold(int kernel, void* const* ptrs, const int* units,
                      const int* code, long long count, long long unit,
                      int qblock, int n, int op, int avg, double alpha,
                      int ctas, int threads, long long glo, long long ghi,
                      cudaStream_t stream) {
  const void* kern = select_wire(kernel);
  const int vals = 1 << ((kernel - WIRE_KERNELS) & 3);
  const long long groups = (unit + qblock - 1) / qblock;
  if (kern == nullptr || n < 1 || unit < 1 || count % unit != 0 ||
      qblock < 1 || qblock > WIRE_MAX_QBLOCK || vals * WARP < qblock ||
      (vals > 1 && vals * WARP / 2 >= qblock) || threads != WIRE_THREADS ||
      glo < 0 || glo > ghi || ghi > count / unit * groups)
    return (int)cudaErrorInvalidValue;
  WireArgs a{ptrs, units, code, count, unit, groups, glo, ghi,
             qblock, n, op, avg, (float)alpha};
  void* params[] = {&a};
  cudaError_t e = cudaLaunchKernel(kern, dim3(ctas), dim3(threads), params,
                                   0, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* ucc_gen_device_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
