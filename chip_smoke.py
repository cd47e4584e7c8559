#!/usr/bin/env python3
"""Drive ucc_tpu_torch's main path on one NVIDIA GPU and hold its CUDA
kernels against their plain PyTorch versions.

Run from the root of a checkout, on a machine with a CUDA GPU and nvcc:

    python3 chip_smoke.py

Phases, each printing its own lines (any failure exits non-zero):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the time to build the nine kernel sources from
   ucc_tpu_torch/csrc/ and its CUDA IPC source (cuda_ipc.cu, host code
   only), one nvcc each, started together, beside one nvcc -Xptxas -v
   for each kernel source; the f32 and bf16 instances of the flag-free
   kernels (allreduce, reduce_scatter, the generated programs' fold,
   alltoall; the bcast's and the allgather's 4- and 2-byte ones) must
   hold 128-bit global loads and stores in their SASS (cuobjdump), and
   none of their instances may spill or have a stack frame; the instances
   of every source that do are printed; neither may the 8 instances of
   the generated wire fold (gen_device.cu) or the f32, f16 and bf16 ones
   of ec_reduce.cu's scalar and vector kernels (216 instances in all), and
   the wire fold's instances of 4 and 8 values a lane and ec_reduce's
   vector f32 and bf16 SUM instances must hold 128-bit global loads and
   stores; every f32 instance of the attention kernel must hold 128-bit shared loads (LDS.128) and have no
   stack frame or spill, and its FFMA and LDS counts are printed;
2. kernels, each launch bitwise equal to its plain version on the same
   CUDA tensors, n in {2, 4, 8}, f32/bf16/int32, ragged counts, NaN inputs
   for MAX/MIN:
   - both allreduce entry points, SUM/AVG/MAX/MIN/PROD, and at n in
     {3, 5, 7} (odd blocks, so vectors straddle block boundaries), counts
     that are no multiple of the vector width, views with a storage offset
     (f32, bf16, int8; mixed offsets take the kernel's scalar path), in
     place at the main shape, n = 1, n = 257 (above the ranks whose
     pointers a CTA stages in shared memory), and a launch on a faulted
     workspace, which must neither raise nor touch it (the kernel has no
     flags);
   - both reduce_scatter entry points over the five ops, also at n in
     {3, 5, 7} (blocks whose srcs lie at offsets mod 16 that change with
     the block, so one launch runs rows on the vector path and rows on
     the scalar one), on views with a storage offset (f32, bf16, int8),
     at n = 1, at n = 257 and in place at the main shape, and on a faulted
     workspace, which must neither raise nor touch it; both allgather
     entry points (one flag-free kernel), each also byte for byte against
     torch.cat(srcs), at counts of several of the plain version's chunks;
     at n in {3, 5, 7} with blocks whose bytes are no multiple of 16
     (units on the vector path and units on the scalar one in one
     launch), on views with a storage offset (f32, bf16, int8: every
     buffer at +1, mixed offsets, and only some srcs at +1), at n = 16 and
     n = 257, with NaN payloads, infinities and -0.0, in place at the
     main shape, and on a faulted workspace, which must neither raise nor
     touch it; in place for both collectives, f16 and int64 cases and
     n = 1;
   - both bcast entry points (one flag-free kernel) from roots 0, n/2 and
     n-1, ragged counts, each also byte for byte against the root's saved
     src, which must stay untouched when it is not the root's dst, and in
     place (src = dst, as UCC's bcast passes src alone); on views with a
     storage offset (f32, bf16, int8: every buffer at +1, mixed offsets,
     and only the unread non-root srcs at +1), at n = 16 and n = 257, with
     NaN payloads, infinities and -0.0, and in place at the main shape
     from root 3; and both alltoall
     entry points (one flag-free kernel), each also against torch.cat of
     block r of every src, in place; at n in {3, 5, 7} with blocks whose
     bytes are no multiple of 16 (units on the vector path and units on
     the scalar one in one launch), on views with a storage offset (f32,
     bf16, int8), at n = 16 and n = 257, and in place at the main shape;
     f16 and int64 cases and n = 1 for both;
   and a bcast or alltoall launch on a faulted workspace neither raises
   nor touches it;
   - every entry point of those five sources by part, as a team across
     processes launches it (part p of P, P in {2, 3, 4}, n = 8, counts no
     multiple of a vector and several chunks long): each part's launch
     bitwise its plain version's part with every other element untouched,
     every union bitwise the single launch;
   - every ring kernel again on int8, uint8, int16 and float64;
   - both entry points of the generated collectives (gen_device_ring,
     gen_device_gen), each launch asserted on its route: every device
     program at n in {2, 4, 8} on the fold kernel (gen_fold.cu), counts
     nchunks x 37, the nine types it takes, the five ops, bcast roots 0,
     n/2 and n-1, in place; rings, direct exchanges and bcasts at n in
     {3, 5, 16, 32} and halving-doubling at 16 and 32; views with a storage
     offset; in place at the main shape; a fold launch on a faulted
     workspace, which must neither raise nor touch it; int8/fp8
     edge-wire direct exchanges (n 2, 3, 4, 8, the three wirings, qblock 8
     to 256 with partial groups, AVG, MAX, in place, views at +1 and mixed
     offsets) on the wire fold (gen_device.cu), and the wire plans without
     a fold plan (qblock 512, wire runs of two units whose unit is no
     multiple of qblock) on the layer kernel (gen_device.cu), where a set
     error word must raise;
   - the execution component's reduce kernel (ec_reduce) over every type it
     takes x all 11 ops (BAND/BOR/BXOR on integers only), k in {1, 2, 3,
     9} sources, counts {1, 7, 1000, 2^20+3}, alpha None and 0.25, NaNs
     for MAX/MIN, views with every buffer aligned, every buffer one
     element in (scalar head and tail around 16-byte vectors) and mixed
     offsets (scalar throughout) at k in {1, 2, 9}, a strided reduce at an
     odd element offset and a 7-job
     reduce_multi_dst through EcCuda; more than 9 sources and BAND on f32
     must raise;
   - the ring flash-attention kernel (ring_flash_attention_fwd) over a
     covering set of n in {1, 2, 8}, (h, h_kv) in {(4, 4), (8, 2),
     (32, 8)}, d in {8, 64, 128} (and 1, 256), s_local in {3, 100, 1024},
     causal both ways, f32/bf16/f16, within a stated tolerance of its plain
     version (TF32 off), each launch on the route its dtype chooses (f32 on
     CUDA cores, f16/bf16 on tensor cores, counted by tc_launches): bf16
     and f16 at d 8 and 256 with ragged s_local, a peaked softmax (q x 8)
     at the main path's widths, misaligned blocks (2-byte loads), and a
     negative and a zero scale; f32 at n = 3, d 1, 37 and 256, s_local 37
     and 300, blocks at a storage offset of one element (4-byte copies),
     a negative and a zero scale, and a peaked softmax at the main path's
     widths, held to the float64 result: within the f32 tolerance or, as
     the plain version itself misses it there, within twice the plain
     version's distance; mismatched heads must raise ValueError
     and d = 257 ERR_NOT_SUPPORTED;
3. main path: 8 contexts over a ThreadOobWorld, one team, persistent
   requests driven like bench.py (5 warm-up and 20 timed rounds), the
   launch counters zeroed just before each run and read just after:
   - allreduce SUM of 16 Mi f32 (64 MiB) per rank, then of 64 Ki f32;
     each checked against torch.stack(srcs).sum(0) and, bitwise, against
     the plain version;
   - reduce_scatter SUM of 16 Mi f32 in, 2 Mi out per rank (a gradient
     bucket sharded 8 ways), then of 64 Ki f32 in; each checked against
     the block of torch.stack(srcs).sum(0) and, bitwise, the plain version;
   - allgather of 2 Mi f32 in, 16 Mi out per rank, then of 8 Ki f32 in;
     each bitwise equal to torch.cat(srcs) and the plain version;
   - bcast of 16 Mi f32 (a start-up parameter bucket) from root 3, then of
     64 Ki f32 from root 0, src alone on every rank; every buffer bitwise
     the root's data and the plain version;
   - alltoall of 16 Mi f32 per rank (2 Mi per partner: an MoE dispatch of
     8192 tokens x 2048 f32), then of 64 Ki f32; each bitwise equal to
     torch.cat of block r of every src and the plain version;
   - ucc_perftest (ucc_tpu_torch.tools.perftest.main) on CUDA memory:
     reducedt of 2 f32 sources of 64 MiB (one fold step of a gradient
     bucket), of 9 bf16 sources of 32 MiB (the executor's cap, knomial
     radix 8), of 2 f32 sources of 256 KiB (latency bound), each launching
     ec_reduce warmup + iters times and followed by an EcCuda.reduce at its
     shape held bitwise against the plain version; and an 8-rank
     persistent allreduce of 64 MiB, which must launch the chunked ring
     kernel warmup + iters times;
   - the long-context GQA block (ucc_tpu_torch.examples.long_context) at
     Meta Llama 3 8B's attention widths (dm 4096, 32 heads, 8 KV heads,
     head dim 128), bf16 weights from a seeded generator, batch 1 and the
     full 8192-token context over 8 ranks, causal: 5 warm-up and 20 timed
     forwards, which must launch ring_flash_attention_fwd exactly 25
     times, all on the tensor cores; its output is bitwise its
     projections' attention merged through wo, that attention is within
     bf16 tolerance of the plain version and, as a check only, of
     scaled_dot_product_attention on the unsharded tensors;
   - the generated device collectives through tl/torch_ops, UCC_GEN_DEVICE=y
     and a UCC_TL_TORCH_OPS_TUNE pin per run (alg asserted, launches
     counted, every one on the fold route, dst bitwise the plain version):
     allreduce SUM of 16 Mi and
     64 Ki f32 via gen_dev_ring_c2, gen_dev_rhd_r2 and gen_dev_rhd_r8, 16 Mi
     via gen_dev_qint8_direct (UCC_QUANT=int8, its own libs); bcast of
     16 Mi from root 3 and 64 Ki from root 0 via gen_dev_bc_kn_r2 and
     gen_dev_bc_chain_c2; and tl/torch_ops's library-ops default (xla)
     for allreduce and bcast at 16 Mi; then, below the stack, int8 and
     fp8 edge-wire direct exchanges of 16 Mi f32 over 8 ranks on the wire
     fold, and the layer kernel on the same plans, timed in turns;
   - tl/torch_ops as the default device TL (tl/xla's table), each run
     with every kernel counter zeroed before and still 0 after: every
     collective type by the default selection, 8 ranks of 16 Mi f32
     (allreduce, reduce from root 3, bcast from root 3, allgather and
     gather of 2 Mi blocks, allgatherv and gatherv of uneven blocks,
     alltoall, alltoallv with uneven per-pair counts, reduce_scatter of
     16 Mi and of 16 Mi + 3 (near-equal blocks), reduce_scatterv,
     scatter and scatterv from root 3) asserted to select torch_ops's
     xla (barrier, fanin and fanout, of message size 0, its short), moves
     byte for byte against the expected layout, reductions bitwise the
     same torch expression outside the stack and within 1e-5 of float64,
     beside tl/ring_cuda's p50 at the same shape for reduce_scatter,
     allgather and alltoall; ring (pinned) on SUM and AVG at 16 Mi;
     short at 1 KiB for allreduce, bcast, allgather and alltoall;
     bfloat16 PROD at 8 x 4096 within rtol 1e-2 of float64; a 1-rank
     team's allreduce and bcast of CUDA tensors through tl/self, and the
     README's quick start in the port;
4. per kernel: its time alone (CUDA events, reused workspace and pointer
   table), its plain version's, its byte bound, and one PyTorch call as a
   yardstick the package never calls (library_ms), timed in turns with
   the kernel: torch.stack(srcs).sum(0) for allreduce and reduce_scatter,
   n x torch.cat(srcs, out=dst) for allgather, (n-1) x dst.copy_(src_root)
   for bcast, n x torch.cat(block r of every src, out=dst_r) for
   alltoall; for ec_reduce at the three
   reducedt shapes, torch.stack(srcs).sum(0); for the generated kernels,
   torch.stack(srcs).sum(0) (allreduce) or (n-1) x copy_ (bcast), timed
   in turns with the kernel; for
   ring flash-attention at
   the main path's shapes, scaled_dot_product_attention on the unsharded
   (1, 32, 8192, 128) q and (1, 8, 8192, 128) k, v, timed in turns with
   the kernel; the kernel's f32 route (CUDA cores) on the same shapes in
   f32 beside its plain version, and in turns with SDPA in f32; nvcc
   -Xptxas -v's
   registers and spills of
   every instance of the attention source, and the HGMMA (wgmma)
   instructions in each instance's SASS: some in every tensor-core
   instance, none in the f32 ones; and the GQA block's projections, merge
   and whole forward in device time, beside its p50;
5. training, the in-graph API (``ops`` over an in-process
   ``mesh.RankMesh`` of 8 ranks on the card) and the paths built on it,
   f32 with TF32 off, the launch counters zeroed just before each run and
   read just after:
   - the GQA train step of examples/long_context.py at Meta Llama 3 8B's
     attention widths (dm 4096, 32 heads, 8 KV heads, head dim 128), mesh
     dp 2 x sp 4, batch 2 x 4096 tokens, causal, tokens scaled as the GQA
     block's, lr 1.0: 3 steps whose loss must fall, whose replicas must be
     bitwise equal after every step, and whose first step's averaged
     gradients must be within 1e-4 (of max |dense|) of the dense
     single-rank gradient of the global mean loss; ring_flash_attention_fwd
     must launch on the f32 route and never on the tensor cores; then 5
     timed steps: p50 split into forward (the attention kernel's device
     ms beside it), backward, gradient AVG and update, tokens/s and
     torch.cuda.max_memory_allocated; all of it twice, the gradient AVG by
     the default selection (tl/torch_ops's xla) and pinned to tl/ring_cuda,
     which must launch ring_allreduce_chunked;
   - then once each, tl/ring_cuda pinned for allreduce and alltoall, each
     checked against its reference and printed with its p50 over 3 runs:
     the MHA step (32 heads of 128, same mesh and tokens; gradients
     against the dense gradient), the DP x TP step at Llama 3 8B's MLP
     widths (4096 -> 14336, dp 2 x tp 4, 4096 tokens; new weights against
     the dense update), the pipeline (8 stages of 4096, 8 microbatches of
     512; reference_pipeline), MoE at Mixtral 8x7B's expert widths (8
     experts of 4096 -> 14336, one a rank, 1024 tokens a rank, capacity
     factor 1.0; reference_moe), and the ring and Ulysses attentions (32
     heads of 128, 8192 tokens over 8 ranks; reference_attention), within
     float32 rtol 2e-4 / atol 2e-5.

6. core, the library's foundations on the card (ucc_tpu_torch.core.ee,
   Team.create_from_parent, the runtime fallback, coll plugins, metrics
   and profiling), 8 ranks of 16 Mi f32, the launch counters zeroed just
   before each run and read just after:
   - an allreduce triggered by data readiness (EeType.CUDA_STREAM): each
     src made by mul_(2) on a side stream behind a sleep, then
     triggered_post(UccEvent(payload=src)); while the producers run, no
     launch and every request not yet posted, then exactly one launch of
     ring_allreduce_chunked (pinned), dst bitwise the plain version of
     2·src and one post and one completion event per rank; the same by
     the default selection (torch_ops/xla, no kernel); a persistent
     request whose fast re-post lane is armed by two plain rounds, then
     triggered, then plain again (the lane again); a CPU_THREAD EE over
     ThreadMode.MULTIPLE contexts, held until the host sets its events;
     the p50 of 20 triggered rounds beside 20 plain persistent ones on
     the fast lane and 20 with a user callback (the generic path);
   - sub-teams: [0..3] and [4..7] split from the 8-rank team, and [0, 2]
     from the first, pinned to ring_cuda: each 4-rank team runs
     allreduce, reduce_scatter (16 Mi in), allgather (2 Mi in), bcast
     (root 1) and alltoall for 25 rounds, bitwise the plain version, one
     launch a round; the first's kernels timed alone at n = 4 with their
     bound and share; a 4-rank allreduce by the default; the 2-rank
     team's allreduce;
   - the runtime fallback: 5 non-persistent allreduces whose first
     candidate (ring_cuda) fails at post before committing data end OK
     on the next (xla), bitwise xla alone, coll_fallback_runtime 1 per
     rank each; their host time beside xla's alone;
   - a coll plugin registered at run time (a module in sys.modules) adds
     an allreduce to tl/ring_cuda, selected by
     UCC_TL_RING_CUDA_COLL_PLUGINS and TUNE: its inits counted and one
     ring_allreduce_chunked launch per round;
   - UCC_GEN_DEVICE_BACKEND=xla: gen_dev_ring_c2 at 16 Mi as torch ops,
     no launch, bitwise the fold kernel on the same srcs;
   - in child processes of this script (the environment is read at
     import): UCC_STATS=y, the persistent allreduce's 25 rounds count
     coll_posted 25 and coll_fast_repost 24 a rank; UCC_PROFILE_MODE=log,
     4 non-persistent rounds write one coll_allreduce B/E pair a request
     around its task's span of the same id.

7. host, the host transports of one process (tl/shm over the tl/host
   algorithms and the port's native core), 8 ranks:
   - the native core: its path (built from ucc_tpu_torch/native_src/ into
     ucc_tpu_torch/build/) and build seconds; every tl/shm endpoint must
     match natively;
   - every collective type tl/shm serves by the default selection on
     HOST memory (CPU tensors; numpy arrays for alltoallv): allreduce,
     reduce_scatter, allgather, allgatherv, bcast, reduce, gather and
     scatter (root 3), alltoall, alltoallv, barrier, fanin and fanout,
     at 64 Ki and 16 Mi f32 a rank (allgather's, gather's and scatter's
     blocks 1/8 of that) and an int32 allreduce, integer-valued so any
     summation order is exact: every result bitwise its expected value,
     the selected algorithm and the p50 of 20 persistent rounds printed
     beside the host CPU (lscpu), no kernel launched; allreduce and
     alltoall at 16 Mi again on UCC_TL_SHM_NATIVE=n contexts, bitwise
     the native matcher's;
   - on the same 8-rank team, a CUDA allreduce of 16 Mi pinned to
     ring_cuda after the HOST ones: 25 launches of ring_allreduce_chunked,
     bitwise; sub-teams [0..3] and [4..7], whose members must hold one id
     each (so must every team a phase makes with a service team);
   - UCC_CHECK_ASYMMETRIC_DT=y: a CUDA bcast of 16 Mi from root 3 pinned
     to ring_cuda, bitwise with 25 launches, its p50 beside the same
     bcast unchecked; then rank 5 passes INT32: every rank's request ends
     ERR_INVALID_PARAM and ring_bcast_chunked is not launched;
   - the median ms of an 8-rank team create, with its tl/shm service team
     and on contexts without tl/shm.
8. procs, host teams across processes: 4 worker processes of this script
   (``--procs-child``; one rank each, contexts and teams over TcpStoreOob
   on held loopback ports), after the kernels and the native core are
   built:
   - the ipc tier (default TLS): tier ``ipc`` and service team tl/ipc on
     every worker, one id per team across them; allreduce,
     reduce_scatter, allgather, bcast and reduce (root 3), alltoall,
     alltoallv (numpy), barrier and an int32 allreduce at 64 Ki and 1 Mi
     f32 a rank (below the arena's 8 MiB message), integer-valued, each
     bitwise its expected value, the algorithm and the slowest rank's
     p50 of 20 persistent rounds printed beside the host CPU; the
     one-sided algorithms (alltoall and alltoallv ``onesided``,
     allreduce ``sliding_window``, pinned by TUNE, with handles
     exchanged through the team's store and without) end
     ERR_NOT_SUPPORTED on every worker (the arena serves one-sided ops
     within one process, as in the JAX package); a CUDA allreduce of 16
     Mi f32 across the four processes runs on tl/torch_ops (xla) on every
     worker, bitwise the integer sum, with no kernel launch;
   - the socket tier (UCC_TLS=socket,self): the same runs, bitwise, tier
     ``socket``; the one-sided runs OK and bitwise; a team over a
     TcpTreeOob (ppn 2, radix 2);
   - the one-sided algorithms on the ipc tier within one process (4
     ranks, UCC_TL_IPC_ENABLE=y), bitwise;
   - B2 (allreduce) and B9 (alltoall) at 16 Mi f32 pinned to ring_cuda on
     an 8-rank team built over TcpStoreOob in this process: 25 launches
     each, bitwise, p50 beside phase 3's; team create over the store
     against ThreadOob;
   - perftest ``--procs 4 -m host``: allreduce (tier ``ipc``, and
     ``socket`` under UCC_TLS=socket,self) and ``-O -c alltoall``;
   - no ``ucc-torch-ipc-*`` segment is left in /dev/shm, no worker alive.
9. span, device teams across processes (tl/device_sync: CUDA IPC peer
   buffers, a sync area per team, interprocess CUDA events): 8 ranks on
   the card, laid out as 2 processes x 4 ranks and as 4 processes x 2
   ranks of this script (``--span-child``), contexts and teams over
   TcpStoreOob; how the processes share the card (the compute mode from
   nvidia-smi -q, and whether an MPS server runs):
   - tl/ring_cuda pinned (UCC_TL_RING_CUDA_TUNE) for phase 3's ten runs
     (the five collectives at 16 Mi f32 a rank, the allgather's 2 Mi in,
     chunked, and at the one-pass sizes), integer-valued seeded inputs: a
     first round, then 5 warm-up and 20 timed persistent rounds; every
     rank's result bitwise what the kernel's single launch over the same
     eight srcs gives (an in-process team's launch); each process launches
     one part a round and, after the first round, opens no IPC handle and
     sends no descriptor; the slowest process's p50, and each part's
     kernel ms alone (CUDA events, in turns on process 0's copies of the
     eight ranks' buffers) with their sum beside the single launch and
     phase 3's;
   - tl/torch_ops's default (xla) for tests/test_xla_multiprocess.py's
     mode flat at full width: allreduce 16 Mi, gather root 1 and scatter
     root 2 of 2 Mi blocks, allgatherv of uneven counts near 2 Mi, bcast
     root 3 of 16 Mi, alltoallv of uneven pair counts near 2 Mi; every
     result bitwise the library ops an in-process team runs on the same
     srcs, no kernel launched, nothing opened or sent after the first
     round; the slowest process's p50;
   - no ``ucc-torch-dev-*`` or ``ucc-torch-ipc-*`` segment is left in
     /dev/shm, no worker alive.

The last two lines are the kernels record (one record per kernel entry
point or route of the kernel table in PERF.md, the f32 attention route and
the int8/fp8 wire fold and the layer kernel on the same plans among
them, with launches 0: the main path runs none of them; the f32 route's
launches are the GQA train step's, and every record carries its launches
over phase 5 as training_launches, over phase 6 as core_launches, over
phase 7 as host_launches, over phase 8 as procs_launches and over phase
9's spanning rounds, summed over its processes, as span_launches) and
{"ok": true, "device": ...}.
It imports nothing of JAX or of the JAX package, and exits non-zero
without a result when there is no GPU or no package beside it.
"""
import json
import os
import subprocess
import sys
import threading
import time

#: H100 SXM HBM3 rate (NVIDIA data sheet), for bound_ms and roofline share
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM float32 rate outside the tensor cores
F32_FLOPS = 67e12
#: H100 SXM dense bf16/fp16 tensor-core rate
TENSOR16_FLOPS = 989e12

#: GPU cycles of the sleep that cuda_ms queues ahead of a timed run
#: (~50 ms at the H100's 1.98 GHz): longer than the host takes to enqueue
#: 20 wrapper calls
SLEEP_CYCLES = 100_000_000

N_RANKS = 8
MAIN_COUNT = 16 << 20        # 64 MiB of f32 per rank (bench.py's count)
SMALL_COUNT = 64 << 10       # 64 Ki f32 per rank: the one-pass kernel
#: allgather's src per rank: a 16 Mi bucket sharded 8 ways, gathered back
AG_MAIN_COUNT = MAIN_COUNT // N_RANKS
AG_SMALL_COUNT = 8 << 10     # 8 Ki f32 per rank: the one-pass kernel
WARMUP, ITERS = 5, 20
#: f32 sums in another order than the ring's differ by a few ulp of the
#: partial sums: |err| <= (n-1) * 2^-24 * max|partial| ~ 7 * 6e-8 * 20
MAIN_ATOL = 1e-5
MAIN_RTOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bits_equal(a, b) -> bool:
    """Bitwise equality of two tensors, NaN positions compared as NaN."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return bool(torch.equal(a.reshape(-1).view(torch.uint8),
                                b.reshape(-1).view(torch.uint8)))
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False
    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return bool(torch.equal(a.view(view)[~na], b.view(view)[~nb]))


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps runs, by CUDA events. A sleep
    kernel queued first holds the stream while the host enqueues all reps,
    so a call whose host side is slower than its kernels is timed by the
    device, not by the host's launch rate."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def make_inputs(n, count, dtype, op, seed):
    import torch
    from ucc_tpu_torch import ReductionOp
    g = torch.Generator(device="cuda").manual_seed(seed)
    if not dtype.is_floating_point:
        lo = 0 if dtype == torch.uint8 else -50
        return [torch.randint(lo, 50, (count,), generator=g, device="cuda",
                              dtype=dtype) for _ in range(n)]
    srcs = [torch.randn(count, generator=g, device="cuda",
                        dtype=torch.float64 if dtype == torch.float64
                        else torch.float32).to(dtype) for _ in range(n)]
    if op in (ReductionOp.MAX, ReductionOp.MIN):
        srcs[1][3] = float("nan")
    return srcs


def compare(what, dsts, want) -> float:
    """Bitwise comparison of each rank's dst with the plain version's;
    returns the max abs difference (0.0 when equal)."""
    for r, (d, w) in enumerate(zip(dsts, want)):
        if not bits_equal(d, w):
            diff = (d.double() - w.double()).abs().nan_to_num(0).max().item()
            raise AssertionError(f"{what}: rank {r} differs from the plain "
                                 f"version (max abs diff {diff})")
    return max((d.double() - w.double()).abs().nan_to_num(0).max().item()
               for d, w in zip(dsts, want))


def label(wrapper, srcs, op) -> str:
    return (f"{wrapper.__name__} n={len(srcs)} {srcs[0].dtype} "
            f"{getattr(op, 'name', op)} count={srcs[0].numel()}")


def check_kernel(wrapper, ref, srcs, op, inplace=False) -> float:
    """Launch an allreduce kernel and compare it bitwise with the plain
    version on the same tensors; returns the max abs difference."""
    import torch
    want = ref(srcs, op)
    dsts = [s.clone() for s in srcs] if inplace else \
        [torch.full_like(s, 7) for s in srcs]
    wrapper(dsts if inplace else srcs, dsts, op).wait()
    torch.cuda.synchronize()
    return compare(label(wrapper, srcs, op), dsts, want)


def check_reduce_scatter(wrapper, ref, srcs, op, inplace=False) -> float:
    """The same for a reduce_scatter kernel (n·c in, c out per rank). In
    place, the src is the whole dst vector and the result lands in its
    block r; the other blocks must stay as they were."""
    import torch
    want = ref(srcs, op)
    n = len(srcs)
    c = srcs[0].numel() // n
    if inplace:
        full = [s.clone() for s in srcs]
        dsts = [f[r * c:(r + 1) * c] for r, f in enumerate(full)]
        wrapper(full, dsts, op).wait()
    else:
        dsts = [torch.full((c,), 7, dtype=s.dtype, device=s.device)
                for s in srcs]
        wrapper(srcs, dsts, op).wait()
    torch.cuda.synchronize()
    if inplace:
        for r, (f, s) in enumerate(zip(full, srcs)):
            if not (bits_equal(f[:r * c], s[:r * c]) and
                    bits_equal(f[(r + 1) * c:], s[(r + 1) * c:])):
                raise AssertionError(f"{label(wrapper, srcs, op)} in place: "
                                     f"rank {r} wrote outside its block")
    return compare(label(wrapper, srcs, op), dsts, want)


def check_allgather(wrapper, ref, srcs, inplace=False) -> float:
    """The same for an allgather kernel (c in, n·c out per rank), which
    must also be byte for byte torch.cat(srcs) (NaN payloads and the sign
    of zero included). In place, the src is block r of the dst."""
    import torch
    want = ref(srcs)
    n = len(srcs)
    c = srcs[0].numel()
    dsts = [torch.full((n * c,), 7, dtype=s.dtype, device=s.device)
            for s in srcs]
    if inplace:
        for r, d in enumerate(dsts):
            d[r * c:(r + 1) * c] = srcs[r]
        wrapper([d[r * c:(r + 1) * c] for r, d in enumerate(dsts)],
                dsts).wait()
    else:
        wrapper(srcs, dsts).wait()
    torch.cuda.synchronize()
    cat = torch.cat(srcs)
    what = label(wrapper, srcs, None) + (" in place" if inplace else "")
    for r, d in enumerate(dsts):
        if not raw_equal(d, cat):
            raise AssertionError(f"{what}: rank {r} is not byte for byte "
                                 f"torch.cat(srcs)")
    return compare(what, dsts, want)


def raw_equal(a, b) -> bool:
    """Byte-for-byte equality of two tensors of one dtype and shape (NaN
    payloads and the sign of zero included)."""
    import torch
    return a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def check_bcast(wrapper, ref, srcs, root, inplace=False) -> float:
    """The same for a bcast kernel from `root` (c in, c out per rank),
    which must also be byte for byte the root's src. In place, each rank's
    src is its dst, as when UCC's bcast passes src alone; else the root's
    src must be byte for byte what it was."""
    import torch
    data = srcs[root].clone()
    want = ref(srcs, root)
    if inplace:
        dsts = [s.clone() for s in srcs]
        wrapper(dsts, dsts, root=root).wait()
    else:
        dsts = [torch.full_like(s, 7) for s in srcs]
        wrapper(srcs, dsts, root=root).wait()
    torch.cuda.synchronize()
    what = f"{label(wrapper, srcs, None)} root={root}"
    for r, d in enumerate(dsts):
        if not raw_equal(d, data):
            raise AssertionError(f"{what}: rank {r} is not byte for byte "
                                 f"the root's src")
    if not inplace and not raw_equal(srcs[root], data):
        raise AssertionError(f"{what}: the root's src changed")
    return compare(what, dsts, want)


def alltoall_expected(srcs):
    """dst_r of an alltoall: torch.cat of block r of every src."""
    import torch
    n = len(srcs)
    b = srcs[0].numel() // n
    return [torch.cat([s[r * b:(r + 1) * b] for s in srcs])
            for r in range(n)]


def check_alltoall(wrapper, ref, srcs, inplace=False) -> float:
    """The same for an alltoall kernel (n·b in, n·b out per rank), which
    must also be bitwise torch.cat of block r of every src. In place, the
    src is the dst."""
    import torch
    want = ref(srcs)
    if inplace:
        dsts = [s.clone() for s in srcs]
        wrapper(dsts, dsts).wait()
    else:
        dsts = [torch.full_like(s, 7) for s in srcs]
        wrapper(srcs, dsts).wait()
    torch.cuda.synchronize()
    what = label(wrapper, srcs, None) + (" in place" if inplace else "")
    compare(what + " vs cat", dsts, alltoall_expected(srcs))
    return compare(what, dsts, want)


def expect_fault(launch) -> None:
    """A launch on a workspace whose error word is already set: every spin
    gives up, and the wrapper must report it."""
    from ucc_tpu_torch import Status, UccError
    try:
        launch().wait()
    except UccError as e:
        if e.status != Status.ERR_TIMED_OUT:
            raise
    else:
        raise AssertionError("a set error word did not make the wrapper "
                             "raise")


def faulted_workspace():
    import torch
    from ucc_tpu_torch.kernels import ring_common as kc
    ws = kc.RingWorkspace(torch.device("cuda"))
    ws.get(0, 0)
    ws.err.fill_(1)
    return ws


def phase_kernels() -> None:
    import torch
    from ucc_tpu_torch import ReductionOp
    from ucc_tpu_torch.kernels import ring_allreduce as kr
    t0 = time.perf_counter()
    ops = kr.OPS
    cases = 0
    for n in (2, 4, 8):
        pass_count = kr.pass_elems(n) // 3 + 5          # not a multiple of n
        chunked_count = 2 * kr.pass_elems(n) + 3        # 3 chunks, ragged
        for dtype in (torch.float32, torch.bfloat16, torch.int32):
            for i, op in enumerate(ops):
                seed = 1000 * n + 10 * i + dtype.itemsize
                check_kernel(kr.ring_allreduce_pass, kr.ring_allreduce_pass_ref,
                             make_inputs(n, pass_count, dtype, op, seed), op)
                check_kernel(kr.ring_allreduce_chunked,
                             kr.ring_allreduce_chunked_ref,
                             make_inputs(n, chunked_count, dtype, op,
                                         seed + 1), op)
                cases += 2
    # in place, and the two further dtypes the kernels take
    for dtype in (torch.float16, torch.int64):
        srcs = make_inputs(4, 1001, dtype, ReductionOp.SUM, 5)
        check_kernel(kr.ring_allreduce_pass, kr.ring_allreduce_pass_ref,
                     srcs, ReductionOp.SUM)
        cases += 1
    check_kernel(kr.ring_allreduce_chunked, kr.ring_allreduce_chunked_ref,
                 make_inputs(8, kr.pass_elems(8) + 17, torch.float32,
                             ReductionOp.AVG, 6), ReductionOp.AVG,
                 inplace=True)
    cases += 1
    # odd n: blocks of odd length (the pass kernel's 10001; the chunked
    # kernel's 349525 and 209715, and n = 7's 149796, no multiple of 8),
    # so vectors straddle block boundaries
    for n in (3, 5, 7):
        for dtype in (torch.float32, torch.bfloat16):
            for i, op in enumerate(ops):
                seed = 2000 * n + 10 * i + dtype.itemsize
                check_kernel(kr.ring_allreduce_pass,
                             kr.ring_allreduce_pass_ref,
                             make_inputs(n, n * 10001 - 1, dtype, op, seed),
                             op)
                check_kernel(kr.ring_allreduce_chunked,
                             kr.ring_allreduce_chunked_ref,
                             make_inputs(n, 2 * kr.pass_elems(n) + 3, dtype,
                                         op, seed + 1), op)
                cases += 2
    # counts that are no multiple of the vector width (4, 8, 16 elements)
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for wrapper, ref in ((kr.ring_allreduce_pass,
                              kr.ring_allreduce_pass_ref),
                             (kr.ring_allreduce_chunked,
                              kr.ring_allreduce_chunked_ref)):
            check_kernel(wrapper, ref, make_inputs(
                4, 16 * 1021 + 13, dtype, ReductionOp.SUM, 8), ReductionOp.SUM)
            cases += 1
    # views with a storage offset: some ranks at +1 element (every element
    # on the kernel's scalar path), or every buffer at +1 (a scalar head,
    # then vectors)
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for wrapper, ref, count in (
                (kr.ring_allreduce_pass, kr.ring_allreduce_pass_ref, 40003),
                (kr.ring_allreduce_chunked, kr.ring_allreduce_chunked_ref,
                 kr.pass_elems(5) + 37)):
            for mixed in (True, False):
                check_misaligned(wrapper, ref, 5, count, dtype, mixed, 9)
                cases += 1
    # n = 1 (a copy; AVG still divides), and a team above the ranks whose
    # pointers a CTA stages in shared memory (integer SUM: any order is
    # exact, so the check is torch's sum rather than the slow ring)
    check_kernel(kr.ring_allreduce_pass, kr.ring_allreduce_pass_ref,
                 make_inputs(1, 1001, torch.float32, ReductionOp.SUM, 11),
                 ReductionOp.SUM)
    check_kernel(kr.ring_allreduce_chunked, kr.ring_allreduce_chunked_ref,
                 make_inputs(1, kr.pass_elems(1) + 5, torch.int32,
                             ReductionOp.AVG, 12), ReductionOp.AVG,
                 inplace=True)
    srcs = make_inputs(257, 1001, torch.int32, ReductionOp.SUM, 13)
    dsts = [torch.empty_like(s) for s in srcs]
    kr.ring_allreduce_pass(srcs, dsts, ReductionOp.SUM).wait()
    compare("ring_allreduce_pass n=257", dsts,
            [torch.stack(srcs).sum(0, dtype=torch.int32)] * 257)
    cases += 3
    # in place at the main path's shape
    check_kernel(kr.ring_allreduce_chunked, kr.ring_allreduce_chunked_ref,
                 make_inputs(N_RANKS, MAIN_COUNT, torch.float32,
                             ReductionOp.SUM, 10), ReductionOp.SUM,
                 inplace=True)
    cases += 1
    torch.cuda.empty_cache()
    check_flag_free()
    log(f"kernels: {cases} allreduce launches bitwise equal to their plain "
        f"versions (n in 2,4,8 x f32/bf16/int32 and n in 3,5,7 x f32/bf16, "
        f"x SUM/AVG/MAX/MIN/PROD; ragged counts; NaN for MAX/MIN; f16, "
        f"int64; misaligned views; n = 1 and 257; in place, also at 8 x "
        f"{MAIN_COUNT}) in "
        f"{time.perf_counter() - t0:.1f} s; an allreduce, reduce_scatter, "
        f"allgather, alltoall or bcast launch on a faulted workspace neither "
        f"raises nor touches it")


def check_misaligned(wrapper, ref, n, count, dtype, mixed, seed,
                     dst_count=None) -> float:
    """An allreduce or alltoall (or, with *dst_count*, a reduce_scatter)
    over views with a storage offset, bitwise against the plain version
    ``ref(srcs, op)``: *mixed*,
    srcs of odd ranks and dsts of ranks 0 mod 3 start one element in;
    else every src and dst does. The elements around each dst view must
    stay as they were."""
    import torch
    from ucc_tpu_torch import ReductionOp
    op = ReductionOp.SUM
    dst_count = count if dst_count is None else dst_count
    bases = make_inputs(n, count + 1, dtype, op, seed)
    src_at = [r % 2 if mixed else 1 for r in range(n)]
    dst_at = [int(r % 3 == 0) if mixed else 1 for r in range(n)]
    srcs = [b[a:a + count] for b, a in zip(bases, src_at)]
    outs = [torch.full((dst_count + 1,), 7, dtype=dtype, device="cuda")
            for _ in range(n)]
    dsts = [o[a:a + dst_count] for o, a in zip(outs, dst_at)]
    want = ref(srcs, op)
    wrapper(srcs, dsts, op).wait()
    torch.cuda.synchronize()
    what = (f"{label(wrapper, srcs, op)} views at "
            f"{'mixed offsets' if mixed else '+1'}")
    for r, (o, a) in enumerate(zip(outs, dst_at)):
        rest = torch.cat([o[:a], o[a + dst_count:]])
        if not torch.equal(rest, torch.full_like(rest, 7)):
            raise AssertionError(f"{what}: rank {r} wrote outside its dst")
    return compare(what, dsts, want)


def check_flag_free() -> None:
    """The allreduce, reduce_scatter, allgather, alltoall and bcast kernels
    have no flags and no error word: a launch on a workspace whose error word is
    set and whose flag words hold a pattern must not raise, must be right,
    and must leave both as they were."""
    import torch
    from ucc_tpu_torch import ReductionOp
    from ucc_tpu_torch.kernels import ring_allreduce as kr
    from ucc_tpu_torch.kernels import ring_bcast_a2a as kba
    from ucc_tpu_torch.kernels import ring_rs_ag as krs
    ws = faulted_workspace()
    _, flags, err = ws.get(64, 64)
    flags.fill_(0x5A5A5A5A)
    before = (flags.clone(), err.clone())
    sum_ = ReductionOp.SUM
    for wrapper, ref in ((kr.ring_allreduce_pass, kr.ring_allreduce_pass_ref),
                         (kr.ring_allreduce_chunked,
                          kr.ring_allreduce_chunked_ref)):
        srcs = make_inputs(4, 4096, torch.float32, sum_, 7)
        dsts = [torch.empty_like(s) for s in srcs]
        wrapper(srcs, dsts, sum_, workspace=ws).wait()
        torch.cuda.synchronize()
        compare(label(wrapper, srcs, sum_) + " on a faulted workspace",
                dsts, ref(srcs, sum_))
    for wrapper in (krs.ring_reduce_scatter_pass,
                    krs.ring_reduce_scatter_chunked):
        srcs = make_inputs(4, 4 * 4096, torch.float32, sum_, 18)
        dsts = [torch.empty(4096, device="cuda") for _ in srcs]
        wrapper(srcs, dsts, sum_, workspace=ws).wait()
        torch.cuda.synchronize()
        compare(label(wrapper, srcs, sum_) + " on a faulted workspace",
                dsts, krs.ring_reduce_scatter_ref(srcs, sum_))
    for wrapper, count in ((krs.ring_allgather_pass, 4096),
                           (krs.ring_allgather_chunked,
                            krs.allgather_pass_elems(4) + 3)):
        srcs = make_inputs(4, count, torch.float32, sum_, 28)
        dsts = [torch.empty(4 * count, device="cuda") for _ in srcs]
        wrapper(srcs, dsts, workspace=ws).wait()
        torch.cuda.synchronize()
        compare(label(wrapper, srcs, None) + " on a faulted workspace",
                dsts, krs.ring_allgather_ref(srcs))
    for wrapper in (kba.ring_alltoall_pass, kba.ring_alltoall_chunked):
        srcs = make_inputs(4, 4 * 4096, torch.float32, sum_, 27)
        dsts = [torch.empty_like(s) for s in srcs]
        wrapper(srcs, dsts, workspace=ws).wait()
        torch.cuda.synchronize()
        compare(label(wrapper, srcs, None) + " on a faulted workspace",
                dsts, kba.ring_alltoall_ref(srcs))
    for wrapper, count in ((kba.ring_bcast_pass, 4096),
                           (kba.ring_bcast_chunked, 4 * 4096 + 3)):
        srcs = make_inputs(4, count, torch.float32, sum_, 26)
        dsts = [torch.empty_like(s) for s in srcs]
        wrapper(srcs, dsts, root=2, workspace=ws).wait()
        torch.cuda.synchronize()
        compare(label(wrapper, srcs, None) + " root=2 on a faulted "
                "workspace", dsts, kba.ring_bcast_ref(srcs, 2))
    if not (torch.equal(flags, before[0]) and torch.equal(err, before[1])):
        raise AssertionError("an allreduce, reduce_scatter, allgather, "
                             "alltoall or bcast launch touched the "
                             "workspace")


def phase_kernels_rs_ag() -> None:
    import torch
    from ucc_tpu_torch import ReductionOp
    from ucc_tpu_torch.kernels import ring_rs_ag as krs
    t0 = time.perf_counter()
    rs = (krs.ring_reduce_scatter_pass, krs.ring_reduce_scatter_ref)
    rs_c = (krs.ring_reduce_scatter_chunked, krs.ring_reduce_scatter_ref)
    ag = (krs.ring_allgather_pass, krs.ring_allgather_ref)
    ag_c = (krs.ring_allgather_chunked, krs.ring_allgather_ref)
    cases = 0
    for n in (2, 4, 8):
        chunk = krs.CHUNK_ELEMS // n
        # blocks ragged against the lanes, and 3 chunks, the last ragged
        rs_pass_blk = krs.reduce_scatter_pass_elems(n) // n // 3 + 5
        ag_pass_blk = krs.allgather_pass_elems(n) // 3 + 5
        chunked_blk = 2 * chunk + 3
        for dtype in (torch.float32, torch.bfloat16, torch.int32):
            for i, op in enumerate(krs.OPS):
                seed = 2000 * n + 10 * i + dtype.itemsize
                check_reduce_scatter(*rs, make_inputs(
                    n, n * rs_pass_blk, dtype, op, seed), op)
                check_reduce_scatter(*rs_c, make_inputs(
                    n, n * chunked_blk, dtype, op, seed + 1), op)
                cases += 2
            # a NaN in rank 1's block must arrive as it left
            seed = 3000 * n + dtype.itemsize
            check_allgather(*ag, make_inputs(n, ag_pass_blk, dtype,
                                             ReductionOp.MAX, seed))
            check_allgather(*ag_c, make_inputs(n, chunked_blk, dtype,
                                               ReductionOp.MAX, seed + 1))
            cases += 2
    # in place, the two further dtypes, and one rank
    big = 2 * (krs.CHUNK_ELEMS // 8) + 17
    check_reduce_scatter(*rs_c, make_inputs(
        8, 8 * big, torch.float32, ReductionOp.AVG, 8), ReductionOp.AVG,
        inplace=True)
    check_reduce_scatter(*rs, make_inputs(
        4, 4 * 1001, torch.bfloat16, ReductionOp.SUM, 9), ReductionOp.SUM,
        inplace=True)
    check_allgather(*ag_c, make_inputs(8, big, torch.float32,
                                       ReductionOp.SUM, 10), inplace=True)
    check_allgather(*ag, make_inputs(4, 1001, torch.int32, ReductionOp.SUM,
                                     11), inplace=True)
    check_reduce_scatter(*rs, make_inputs(
        4, 4 * 1001, torch.float16, ReductionOp.AVG, 12), ReductionOp.AVG)
    check_reduce_scatter(*rs_c, make_inputs(
        4, 4 * 1001, torch.int64, ReductionOp.PROD, 13), ReductionOp.PROD)
    check_allgather(*ag, make_inputs(4, 1001, torch.float16,
                                     ReductionOp.SUM, 14))
    check_allgather(*ag_c, make_inputs(4, 1001, torch.int64,
                                       ReductionOp.SUM, 15))
    check_reduce_scatter(*rs, make_inputs(1, 777, torch.float32,
                                          ReductionOp.AVG, 16),
                         ReductionOp.AVG)
    check_allgather(*ag, make_inputs(1, 777, torch.float32,
                                     ReductionOp.SUM, 17))
    cases += 10
    cases += reduce_scatter_edges(rs, rs_c)
    cases += allgather_edges(ag, ag_c)
    log(f"kernels: {cases} reduce_scatter/allgather launches bitwise equal "
        f"to their plain versions (n in 2,4,8; f32/bf16/int32; "
        f"reduce_scatter x SUM/AVG/MAX/MIN/PROD with NaN for MAX/MIN, also "
        f"at n in 3,5,7, on misaligned views, at n = 1 and 257 and in place "
        f"at 8 x {MAIN_COUNT}; allgather byte for byte torch.cat, also at n "
        f"in 3,5,7 with blocks misaligned per unit, on misaligned views, at "
        f"n = 16 and 257, with NaN payloads, infinities and -0.0 and in "
        f"place at 8 x {AG_MAIN_COUNT}; ragged counts; 3 chunks; in place; "
        f"f16, int64; n=1) in {time.perf_counter() - t0:.1f} s (neither has "
        f"flags or an error word: check_flag_free)")


def reduce_scatter_edges(rs, rs_c) -> int:
    """The reduce_scatter kernel's edges, each launch bitwise against the
    plain version: odd n, whose blocks put the srcs' block r at offsets
    mod 16 that change with r (rows on the vector path and rows on the
    scalar one in one launch); views with a storage offset (at blocks of
    4096 every row of "+1" views takes vectors after a scalar head, at
    40003 some rows run scalar); n = 1; n = 257, more ranks than the card
    holds co-resident CTAs (integer SUM: any order is exact, so the check
    is torch's sum rather than the slow ring); in place at the main path's
    shape. Returns the launches."""
    import torch
    from ucc_tpu_torch import ReductionOp
    from ucc_tpu_torch.kernels import ring_rs_ag as krs
    cases = 0
    for n in (3, 5, 7):
        for dtype in (torch.float32, torch.bfloat16):
            for i, op in enumerate(krs.OPS):
                seed = 6000 * n + 10 * i + dtype.itemsize
                check_reduce_scatter(*rs, make_inputs(
                    n, n * 10001, dtype, op, seed), op)
                check_reduce_scatter(*rs_c, make_inputs(
                    n, n * (2 * (krs.CHUNK_ELEMS // n) + 3), dtype, op,
                    seed + 1), op)
                cases += 2
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for blk in (4096, 40003):
            for mixed in (True, False):
                check_misaligned(*rs, 5, 5 * blk, dtype, mixed, 9,
                                 dst_count=blk)
                cases += 1
    check_reduce_scatter(*rs_c, make_inputs(
        1, krs.reduce_scatter_pass_elems(1) + 5, torch.int32,
        ReductionOp.AVG, 19), ReductionOp.AVG, inplace=True)
    srcs = make_inputs(257, 257 * 1001, torch.int32, ReductionOp.SUM, 20)
    dsts = [torch.empty(1001, dtype=torch.int32, device="cuda")
            for _ in srcs]
    krs.ring_reduce_scatter_pass(srcs, dsts, ReductionOp.SUM).wait()
    total = torch.stack(srcs).sum(0, dtype=torch.int32)
    compare("ring_reduce_scatter_pass n=257", dsts,
            [total[r * 1001:(r + 1) * 1001] for r in range(257)])
    del srcs, dsts, total
    check_reduce_scatter(*rs_c, make_inputs(
        N_RANKS, MAIN_COUNT, torch.float32, ReductionOp.SUM, 21),
        ReductionOp.SUM, inplace=True)
    torch.cuda.empty_cache()
    return cases + 3


def check_allgather_views(wrapper, n, count, dtype, src_at, dst_at,
                          seed) -> None:
    """An allgather over views with a storage offset: rank r's src starts
    src_at[r] elements into its base, its dst dst_at[r] elements in. Every
    dst must be byte for byte torch.cat(srcs) and bitwise the plain
    version, the elements around each dst view must stay as they were."""
    import torch
    from ucc_tpu_torch import ReductionOp
    from ucc_tpu_torch.kernels import ring_rs_ag as krs
    bases = make_inputs(n, count + 1, dtype, ReductionOp.MAX, seed)
    srcs = [b[a:a + count] for b, a in zip(bases, src_at)]
    outs = [torch.full((n * count + 1,), 7, dtype=dtype, device="cuda")
            for _ in range(n)]
    dsts = [o[a:a + n * count] for o, a in zip(outs, dst_at)]
    want = krs.ring_allgather_ref(srcs)
    wrapper(srcs, dsts).wait()
    torch.cuda.synchronize()
    what = (f"{label(wrapper, srcs, None)} views, srcs at {src_at}, dsts "
            f"at {dst_at}")
    cat = torch.cat(srcs)
    for r, (o, a) in enumerate(zip(outs, dst_at)):
        rest = torch.cat([o[:a], o[a + n * count:]])
        if not torch.equal(rest, torch.full_like(rest, 7)):
            raise AssertionError(f"{what}: rank {r} wrote outside its dst")
        if not raw_equal(dsts[r], cat):
            raise AssertionError(f"{what}: rank {r} is not byte for byte "
                                 f"torch.cat(srcs)")
    compare(what, dsts, want)


def allgather_edges(ag, ag_c) -> int:
    """The allgather kernel's edges, each launch byte for byte
    torch.cat(srcs) and bitwise the plain version, for both entry points:
    odd n with blocks whose bytes are no multiple of 16, so block b of
    every dst lies at an offset mod 16 that changes with b (units on the
    vector path and units on the scalar one in one launch; in place, some
    ranks' blocks are their srcs); views with a storage offset (every
    buffer at +1: a scalar head, then vectors; mixed offsets: the dsts
    disagree, every element on the scalar path; only odd ranks' srcs at
    +1: their units scalar while the dsts are aligned); n = 16, and n =
    257, above the ranks whose pointers a CTA stages in shared memory; NaN
    payloads, infinities and -0.0; in place at the main path's shape.
    Returns the launches."""
    import torch
    from ucc_tpu_torch import ReductionOp
    from ucc_tpu_torch.kernels import ring_rs_ag as krs
    cases = 0
    for n in (3, 5, 7):
        # odd counts above the pass size: c·B is no multiple of 16
        chunked = krs.allgather_pass_elems(n) // 2 * 2 + 3
        for dtype in (torch.float32, torch.bfloat16):
            seed = 8000 * n + dtype.itemsize
            check_allgather(*ag, make_inputs(n, 10001, dtype,
                                             ReductionOp.MAX, seed))
            check_allgather(*ag_c, make_inputs(n, chunked, dtype,
                                               ReductionOp.MAX, seed + 1),
                            inplace=dtype == torch.bfloat16)
            cases += 2
    n = 5
    layouts = (([1] * n, [1] * n),
               ([r % 2 for r in range(n)], [int(r % 3 == 0)
                                             for r in range(n)]),
               ([r % 2 for r in range(n)], [0] * n))
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for wrapper, count in ((ag[0], 4096), (ag[0], 40003),
                               (ag_c[0], krs.allgather_pass_elems(n) + 37)):
            for src_at, dst_at in layouts:
                check_allgather_views(wrapper, n, count, dtype, src_at,
                                      dst_at, 60 + cases)
                cases += 1
    check_allgather(*ag, make_inputs(16, krs.allgather_pass_elems(16) // 3
                                     + 5, torch.float32, ReductionOp.MAX,
                                     70))
    check_allgather(*ag_c, make_inputs(16, krs.allgather_pass_elems(16) + 7,
                                       torch.bfloat16, ReductionOp.SUM, 71),
                    inplace=True)
    check_allgather(*ag, make_inputs(257, 1001, torch.float32,
                                     ReductionOp.MAX, 72))
    check_allgather(*ag_c, make_inputs(257, krs.allgather_pass_elems(257)
                                       + 5, torch.int32, ReductionOp.SUM,
                                       73), inplace=True)
    cases += 4
    for dtype in (torch.float32, torch.bfloat16):
        check_allgather(*ag, special_values(4, 10007, dtype, 74))
        check_allgather(*ag_c, special_values(
            4, krs.allgather_pass_elems(4) + 9, dtype, 75), inplace=True)
        cases += 2
    check_allgather(*ag_c, make_inputs(N_RANKS, AG_MAIN_COUNT, torch.float32,
                                       ReductionOp.MAX, 76), inplace=True)
    check_allgather(*ag, make_inputs(N_RANKS, AG_SMALL_COUNT, torch.float32,
                                     ReductionOp.MAX, 77), inplace=True)
    torch.cuda.empty_cache()
    return cases + 2


def phase_kernels_bcast_a2a() -> None:
    import torch
    from ucc_tpu_torch import ReductionOp
    from ucc_tpu_torch.kernels import ring_bcast_a2a as kba
    t0 = time.perf_counter()
    bc = (kba.ring_bcast_pass, kba.ring_bcast_ref)
    bc_c = (kba.ring_bcast_chunked, kba.ring_bcast_ref)
    a2a = (kba.ring_alltoall_pass, kba.ring_alltoall_ref)
    a2a_c = (kba.ring_alltoall_chunked, kba.ring_alltoall_ref)
    sub = kba.CHUNK_ELEMS // 2
    cases = 0
    for n in (2, 4, 8):
        # bcast: 2 sub-blocks at the pass size, 4 at the chunked one, the
        # last ragged against the sub-block and the lanes
        bc_pass, bc_chunked = kba.CHUNK_ELEMS - 3, 3 * sub + 7
        # alltoall: blocks ragged against the lanes, and 3 chunks per
        # block, the last ragged
        a2a_pass_blk = kba.CHUNK_ELEMS // n // 3 + 5
        a2a_chunked_blk = 2 * (kba.CHUNK_ELEMS // n) + 3
        for dtype in (torch.float32, torch.bfloat16, torch.int32):
            for i, root in enumerate((0, n // 2, n - 1)):
                seed = 4000 * n + 10 * i + dtype.itemsize
                # MAX puts a NaN into rank 1's input: it must travel as is
                check_bcast(*bc, make_inputs(n, bc_pass, dtype,
                                             ReductionOp.MAX, seed), root)
                check_bcast(*bc_c, make_inputs(n, bc_chunked, dtype,
                                               ReductionOp.MAX, seed + 1),
                            root)
                cases += 2
            seed = 5000 * n + dtype.itemsize
            check_alltoall(*a2a, make_inputs(n, n * a2a_pass_blk, dtype,
                                             ReductionOp.MAX, seed))
            check_alltoall(*a2a_c, make_inputs(n, n * a2a_chunked_blk,
                                               dtype, ReductionOp.MAX,
                                               seed + 1))
            check_alltoall(*a2a_c, make_inputs(n, n * a2a_chunked_blk,
                                               dtype, ReductionOp.SUM,
                                               seed + 2), inplace=True)
            cases += 3
        check_alltoall(*a2a, make_inputs(n, n * a2a_pass_blk, torch.float32,
                                         ReductionOp.SUM, 5100 + n),
                       inplace=True)
        check_bcast(*bc_c, make_inputs(n, bc_chunked, torch.float32,
                                       ReductionOp.SUM, 5200 + n), n - 1,
                    inplace=True)
        cases += 2
    # the two further dtypes, one rank, and a bcast of the pass size in
    # place
    for dtype, seed in ((torch.float16, 20), (torch.int64, 21)):
        check_bcast(*bc, make_inputs(4, 1001, dtype, ReductionOp.SUM, seed),
                    2)
        check_bcast(*bc_c, make_inputs(4, 3 * sub + 1, dtype,
                                       ReductionOp.SUM, seed + 2), 1)
        check_alltoall(*a2a, make_inputs(4, 4 * 1001, dtype,
                                         ReductionOp.SUM, seed + 4))
        check_alltoall(*a2a_c, make_inputs(4, 4 * 1001, dtype,
                                           ReductionOp.SUM, seed + 6),
                       inplace=True)
        cases += 4
    check_bcast(*bc, make_inputs(1, 777, torch.float32, ReductionOp.SUM, 22),
                0)
    check_bcast(*bc, make_inputs(1, 777, torch.float32, ReductionOp.SUM, 23),
                0, inplace=True)
    check_alltoall(*a2a, make_inputs(1, 777, torch.float32, ReductionOp.SUM,
                                     24))
    check_bcast(*bc, make_inputs(8, 64 << 10, torch.float32,
                                 ReductionOp.SUM, 25), 0, inplace=True)
    cases += 4
    cases += alltoall_edges(a2a, a2a_c)
    cases += bcast_edges(bc, bc_c)
    log(f"kernels: {cases} bcast/alltoall launches bitwise equal to their "
        f"plain versions (n in 2,4,8; f32/bf16/int32 with a NaN; bcast from "
        f"roots 0, n/2, n-1, byte for byte the root's src, which stays "
        f"untouched, also on misaligned views, at n = 16 and 257, with NaN "
        f"payloads and -0.0 and in place at 8 x {MAIN_COUNT} from root 3; "
        f"alltoall bitwise "
        f"torch.cat of block r, also at n in 3,5,7 with blocks misaligned "
        f"per unit, on misaligned views, at n = 16 and 257 and in place at "
        f"8 x {MAIN_COUNT}; ragged counts; 2-4 sub-blocks, 3 chunks; in "
        f"place for both; f16, int64; n=1) in "
        f"{time.perf_counter() - t0:.1f} s (neither has flags or an error "
        f"word: check_flag_free)")


def alltoall_edges(a2a, a2a_c) -> int:
    """The alltoall kernel's edges, each launch bitwise against the plain
    version and torch.cat of block r: odd n with blocks whose bytes are no
    multiple of 16, so a pair's four addresses lie at offsets mod 16 that
    change with its blocks (units on the vector path and units on the
    scalar one in one launch); views with a storage offset; n = 16; n =
    257, above the ranks whose pointers a CTA stages in shared memory; in
    place at the main path's shape. Returns the launches."""
    import torch
    from ucc_tpu_torch import ReductionOp
    from ucc_tpu_torch.kernels import ring_bcast_a2a as kba
    cases = 0
    for n in (3, 5, 7):
        for dtype in (torch.float32, torch.bfloat16):
            seed = 7000 * n + dtype.itemsize
            check_alltoall(*a2a, make_inputs(
                n, n * (kba.CHUNK_ELEMS // n // 3 + 5), dtype,
                ReductionOp.MAX, seed))
            check_alltoall(*a2a_c, make_inputs(
                n, n * (2 * (kba.CHUNK_ELEMS // n) + 3), dtype,
                ReductionOp.MAX, seed + 1), inplace=dtype == torch.bfloat16)
            cases += 2
    # views with a storage offset: units whose addresses disagree mod 16
    # go element by element, the others take vectors
    def ref(srcs, op):
        return kba.ring_alltoall_ref(srcs)
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for wrapper, blk in ((a2a[0], 4096), (a2a[0], 40003),
                             (a2a_c[0], kba.CHUNK_ELEMS // 5 + 37)):
            for mixed in (True, False):
                check_misaligned(wrapper, ref, 5, 5 * blk, dtype, mixed, 9)
                cases += 1
    check_alltoall(*a2a, make_inputs(16, 16 * (kba.CHUNK_ELEMS // 16 // 3
                                               + 5), torch.float32,
                                     ReductionOp.MAX, 28))
    check_alltoall(*a2a_c, make_inputs(16, 16 * (kba.CHUNK_ELEMS // 16 + 3),
                                       torch.int32, ReductionOp.SUM, 29),
                   inplace=True)
    check_alltoall(*a2a, make_inputs(257, 257 * 67, torch.float32,
                                     ReductionOp.MAX, 30))
    check_alltoall(*a2a_c, make_inputs(N_RANKS, MAIN_COUNT, torch.float32,
                                       ReductionOp.MAX, 31), inplace=True)
    torch.cuda.empty_cache()
    return cases + 4


def check_bcast_views(wrapper, n, count, dtype, root, src_at, dst_at,
                      seed) -> None:
    """A bcast from `root` over views with a storage offset: rank r's src
    starts src_at[r] elements into its base, its dst dst_at[r] elements
    in. Every dst must be byte for byte the root's data and the plain
    version, the elements around each dst view and the root's src must stay
    as they were."""
    import torch
    from ucc_tpu_torch import ReductionOp
    from ucc_tpu_torch.kernels import ring_bcast_a2a as kba
    bases = make_inputs(n, count + 1, dtype, ReductionOp.MAX, seed)
    srcs = [b[a:a + count] for b, a in zip(bases, src_at)]
    data = srcs[root].clone()
    outs = [torch.full((count + 1,), 7, dtype=dtype, device="cuda")
            for _ in range(n)]
    dsts = [o[a:a + count] for o, a in zip(outs, dst_at)]
    want = kba.ring_bcast_ref(srcs, root)
    wrapper(srcs, dsts, root=root).wait()
    torch.cuda.synchronize()
    what = (f"{label(wrapper, srcs, None)} root={root} views, srcs at "
            f"{src_at}, dsts at {dst_at}")
    for r, (o, a) in enumerate(zip(outs, dst_at)):
        rest = torch.cat([o[:a], o[a + count:]])
        if not torch.equal(rest, torch.full_like(rest, 7)):
            raise AssertionError(f"{what}: rank {r} wrote outside its dst")
        if not raw_equal(dsts[r], data):
            raise AssertionError(f"{what}: rank {r} is not byte for byte "
                                 f"the root's src")
    if not raw_equal(srcs[root], data):
        raise AssertionError(f"{what}: the root's src changed")
    compare(what, dsts, want)


def special_values(n, count, dtype, seed):
    """n buffers of `count` floats from a seed, with NaNs of several
    payloads and signs, infinities and -0.0 every few elements."""
    import torch
    from ucc_tpu_torch import ReductionOp
    srcs = make_inputs(n, count, dtype, ReductionOp.SUM, seed)
    ints = {torch.float32: (torch.int32, (0x7FC01234, 0x7F800001,
                                          -0x00400001, -0x80000000,
                                          0x7F800000)),
            torch.bfloat16: (torch.int16, (0x7FC1, 0x7F81, -0x003F,
                                           -0x8000, 0x7F80))}
    view, bits = ints[dtype]
    for s in srcs:
        raw = s.view(view)
        for i, b in enumerate(bits):
            raw[i::7 * len(bits)] = b
    return srcs


def bcast_edges(bc, bc_c) -> int:
    """The bcast kernel's edges, each launch byte for byte the root's src
    and bitwise the plain version: views with a storage offset (every
    buffer at +1: a scalar head, then vectors; mixed offsets: every element
    on the scalar path; only non-root srcs at +1, which the kernel never
    reads and whose offsets decide nothing); n = 16, and n = 257, above the
    ranks whose dst pointers a CTA stages in shared memory; NaN payloads,
    infinities and -0.0; in place at the main path's shape from root 3;
    and, not in place, the root's src untouched (check_bcast). Returns the
    launches."""
    import torch
    from ucc_tpu_torch import ReductionOp
    from ucc_tpu_torch.kernels import ring_bcast_a2a as kba
    cases = 0
    n = 5
    layouts = (([1] * n, [1] * n),
               ([r % 2 for r in range(n)], [int(r % 3 == 0)
                                             for r in range(n)]),
               ([int(r != 2) for r in range(n)], [0] * n))
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for wrapper, count in ((bc[0], 40003),
                               (bc_c[0], kba.CHUNK_ELEMS + 37)):
            for src_at, dst_at in layouts:
                check_bcast_views(wrapper, n, count, dtype, 2, src_at,
                                  dst_at, 9 + cases)
                cases += 1
    for i, root in enumerate((0, 8, 15)):
        check_bcast(*bc, make_inputs(16, kba.CHUNK_ELEMS // 3 + 5,
                                     torch.float32, ReductionOp.MAX,
                                     40 + i), root)
        check_bcast(*bc_c, make_inputs(16, kba.CHUNK_ELEMS + 7,
                                       torch.bfloat16, ReductionOp.SUM,
                                       43 + i), root, inplace=i == 1)
        cases += 2
    check_bcast(*bc, make_inputs(257, 4099, torch.float32, ReductionOp.MAX,
                                 46), 128)
    check_bcast(*bc_c, make_inputs(257, 3 * 4099, torch.int32,
                                   ReductionOp.SUM, 47), 256, inplace=True)
    cases += 2
    for dtype in (torch.float32, torch.bfloat16):
        check_bcast(*bc, special_values(4, 10007, dtype, 48), 1)
        check_bcast(*bc_c, special_values(4, kba.CHUNK_ELEMS + 9, dtype,
                                          49), 3, inplace=True)
        cases += 2
    check_bcast(*bc_c, make_inputs(N_RANKS, MAIN_COUNT, torch.float32,
                                   ReductionOp.MAX, 50), 3, inplace=True)
    check_bcast(*bc_c, make_inputs(N_RANKS, MAIN_COUNT // 4, torch.float32,
                                   ReductionOp.SUM, 51), 5)
    torch.cuda.empty_cache()
    return cases + 2


#: the dtypes the ring kernels gained beside f32/f16/bf16/int32/int64
WIDE_DTYPES = ("int8", "uint8", "int16", "float64")


def phase_kernels_wide_types() -> None:
    """Every ring kernel on int8, uint8, int16 and float64, bitwise against
    its plain version: the allreduce and reduce_scatter kernels over the
    five ops (integer sums and products wrap, AVG truncates), the data
    movers on each type."""
    import torch
    from ucc_tpu_torch.kernels import ring_allreduce as kr
    from ucc_tpu_torch.kernels import ring_bcast_a2a as kba
    from ucc_tpu_torch.kernels import ring_rs_ag as krs
    t0 = time.perf_counter()
    cases = 0
    for t, tname in enumerate(WIDE_DTYPES):
        dtype = getattr(torch, tname)
        for i, op in enumerate(kr.OPS):
            n = (2, 4, 8)[(t + i) % 3]
            seed = 5000 + 10 * t + i
            check_kernel(kr.ring_allreduce_pass, kr.ring_allreduce_pass_ref,
                         make_inputs(n, 1001, dtype, op, seed), op)
            check_kernel(kr.ring_allreduce_chunked,
                         kr.ring_allreduce_chunked_ref,
                         make_inputs(n, kr.pass_elems(n) + 37, dtype, op,
                                     seed + 1), op, inplace=i % 2 == 1)
            check_reduce_scatter(krs.ring_reduce_scatter_pass,
                                 krs.ring_reduce_scatter_ref,
                                 make_inputs(n, n * 501, dtype, op, seed + 2),
                                 op)
            cases += 3
        n = (2, 4, 8)[t % 3]
        big = 2 * (krs.CHUNK_ELEMS // n) + 3
        check_reduce_scatter(krs.ring_reduce_scatter_chunked,
                             krs.ring_reduce_scatter_ref,
                             make_inputs(n, n * big, dtype, kr.OPS[0],
                                         5100 + t), kr.OPS[0])
        check_allgather(krs.ring_allgather_pass, krs.ring_allgather_ref,
                        make_inputs(n, 1001, dtype, kr.OPS[0], 5200 + t))
        check_allgather(krs.ring_allgather_chunked, krs.ring_allgather_ref,
                        make_inputs(n, big, dtype, kr.OPS[0], 5300 + t))
        sub = kba.CHUNK_ELEMS // 2
        check_bcast(kba.ring_bcast_pass, kba.ring_bcast_ref,
                    make_inputs(n, 1001, dtype, kr.OPS[0], 5400 + t), n - 1)
        check_bcast(kba.ring_bcast_chunked, kba.ring_bcast_ref,
                    make_inputs(n, 3 * sub + 1, dtype, kr.OPS[0], 5500 + t),
                    n // 2, inplace=True)
        check_alltoall(kba.ring_alltoall_pass, kba.ring_alltoall_ref,
                       make_inputs(n, n * 1001, dtype, kr.OPS[0], 5600 + t))
        check_alltoall(kba.ring_alltoall_chunked, kba.ring_alltoall_ref,
                       make_inputs(n, n * (kba.CHUNK_ELEMS // n + 5), dtype,
                                   kr.OPS[0], 5700 + t))
        cases += 7
    log(f"kernels: {cases} ring launches on {'/'.join(WIDE_DTYPES)} bitwise "
        f"equal to their plain versions (all ten ring entry points; "
        f"allreduce and "
        f"reduce_scatter x SUM/AVG/MAX/MIN/PROD) in "
        f"{time.perf_counter() - t0:.1f} s")


#: every type the generated device kernel takes (the ring kernels' list)
GEN_DTYPES = ("float32", "float16", "bfloat16", "int32", "int64", "int8",
              "uint8", "int16", "float64")


def wire_direct(n, rs_wire, ag_wire):
    """The direct exchange with int8/fp8 tags on the edges of its reduce
    and gather rounds: a program that reaches the kernel's wire layers (no
    registered candidate does: gen_q*_direct carries its precision on the
    program, which the lowering reads from the edges)."""
    from ucc_tpu_torch import CollType
    from ucc_tpu_torch.dsl.ir import ProgramBuilder
    b = ProgramBuilder("wdirect", CollType.ALLREDUCE, n, n)
    b.next_round()
    for p in range(n):
        for q in range(n):
            if p != q:
                b.send(p, q, to=q, wire=rs_wire)
    for q in range(n):
        for p in range(n):
            if p != q:
                b.reduce(q, q, frm=p, wire=rs_wire)
    b.next_round()
    for q in range(n):
        for p in range(n):
            if p != q:
                b.send(q, q, to=p, wire=ag_wire)
    for p in range(n):
        for q in range(n):
            if p != q:
                b.recv(p, q, frm=q, wire=ag_wire)
    return b.build("gen_wdirect")


def wire_pairs(n, wire):
    """An edge-wired direct exchange over 2n chunks whose reduce round
    moves runs of two chunks (rank q owns chunks 2q and 2q + 1) and whose
    gather round moves them one at a time: at 40 elements a chunk and
    qblock 32 its wire runs are two units long and the unit is no multiple
    of qblock, a plan only the layer kernel runs."""
    from ucc_tpu_torch import CollType
    from ucc_tpu_torch.dsl.ir import ProgramBuilder
    b = ProgramBuilder("wpairs", CollType.ALLREDUCE, n, 2 * n)
    b.next_round()
    for p in range(n):
        for q in range(n):
            if p != q:
                for c in (2 * q, 2 * q + 1):
                    b.send(p, c, to=q, wire=wire)
    for q in range(n):
        for p in range(n):
            if p != q:
                for c in (2 * q, 2 * q + 1):
                    b.reduce(q, c, frm=p, wire=wire)
    b.next_round()
    for q in range(n):
        for p in range(n):
            if p != q:
                for c in (2 * q + 1, 2 * q):
                    b.send(q, c, to=p, wire=wire)
    for p in range(n):
        for q in range(n):
            if p != q:
                for c in (2 * q + 1, 2 * q):
                    b.recv(p, c, frm=q, wire=wire)
    return b.build("gen_wpairs")


#: the routes of the generated entry points that count fold_launches
FOLD_ROUTES = ("fold", "wire fold")


def gen_route(prog, n, count, root=0, qblock=256, qmode=""):
    """(plan, entry point, route) of *prog* at *count*: the ring or the
    general entry point, as the lowering picks, and "fold" (gen_fold.cu)
    when the plan has an exact fold plan, "wire fold" (gen_device.cu's
    wire fold) when it has a wire fold plan, else "layer" (gen_device.cu's
    layer kernel)."""
    from ucc_tpu_torch.dsl import lower_device as ld
    from ucc_tpu_torch.kernels import gen_device as kgd
    plan = ld.device_plan(prog, n, count, root, qblock, qmode)
    wrapper = kgd.gen_device_ring if plan.ring else kgd.gen_device_gen
    fp = kgd.fold_plan(plan)
    route = "layer" if fp is None else "wire fold" if fp.qmode else "fold"
    return plan, wrapper, route


def launch_gen(wrapper, route, *args, **kw):
    """One call of a generated entry point that must launch once, on
    *route* (a fold route adds one to fold_launches, the layer kernel
    does not); returns its handle."""
    before = (wrapper.launches, wrapper.fold_launches)
    h = wrapper(*args, **kw)
    want = (before[0] + 1, before[1] + (route in FOLD_ROUTES))
    if (wrapper.launches, wrapper.fold_launches) != want:
        raise AssertionError(
            f"{wrapper.__name__}: (launches, fold_launches) went from "
            f"{before} to {(wrapper.launches, wrapper.fold_launches)}, want "
            f"{want} (route {route})")
    return h


def check_gen(prog, n, srcs, op, root=0, inplace=False, qblock=256,
              qmode="", route="fold") -> float:
    """One launch of the generated kernel's entry point for *prog* (ring or
    layers, as the lowering picks) on *route*, bitwise against
    gen_device_ref on the same tensors; bcast results also bitwise the
    root's src."""
    import torch
    from ucc_tpu_torch.kernels import gen_device as kgd
    plan, wrapper, got = gen_route(prog, n, srcs[0].numel(), root, qblock,
                                   qmode)
    what = (f"{wrapper.__name__} {prog.name} n={n} {srcs[0].dtype} "
            f"{getattr(op, 'name', op)} count={srcs[0].numel()} root={root}"
            f"{' in place' if inplace else ''}{' ' + qmode if qmode else ''}")
    if got != route:
        raise AssertionError(f"{what}: route {got}, want {route}")
    data = srcs[root].clone()
    want = kgd.gen_device_ref(srcs, plan, op)
    dsts = [s.clone() for s in srcs] if inplace else \
        [torch.full_like(s, 7) for s in srcs]
    launch_gen(wrapper, route, dsts if inplace else srcs, dsts, op,
               plan=plan).wait()
    torch.cuda.synchronize()
    if not plan.reducing:
        compare(what + " vs the root's src", dsts, [data] * n)
    return compare(what, dsts, want)


def check_gen_views(prog, n, count, dtype, mixed, seed) -> float:
    """A generated collective over views with a storage offset, as
    check_misaligned runs the allreduce (*mixed*: srcs of odd ranks and
    dsts of ranks 0 mod 3 one element in, else every buffer), on the fold
    route, bitwise against gen_device_ref."""
    from ucc_tpu_torch.kernels import gen_device as kgd
    plan, wrapper, route = gen_route(prog, n, count, n - 1)

    def entry(srcs, dsts, op):
        return launch_gen(wrapper, "fold", srcs, dsts, op, plan=plan)

    entry.__name__ = f"{wrapper.__name__} {prog.name}"
    if route != "fold":
        raise AssertionError(f"{entry.__name__}: route {route}, want fold")
    return check_misaligned(entry, lambda s, op: kgd.gen_device_ref(
        s, plan, op), n, count, dtype, mixed, seed)


def check_gen_flag_free(srcs) -> None:
    """The fold route has no flags and no error word: gen_ring_c1 and
    gen_rhd_r2 on a workspace whose error word is set and whose flag words
    hold a pattern must not raise, must be right, and must leave both as
    they were."""
    import torch
    from ucc_tpu_torch import ReductionOp
    from ucc_tpu_torch.dsl import lower_device as ld
    from ucc_tpu_torch.kernels import gen_device as kgd
    ws = faulted_workspace()
    _, flags, err = ws.get(64, 64)
    flags.fill_(0x5A5A5A5A)
    before = (flags.clone(), err.clone())
    n = len(srcs)
    for name in ("gen_ring_c1", "gen_rhd_r2"):
        prog = next(p for p in ld.device_programs(n) if p.name == name)
        plan, wrapper, route = gen_route(prog, n, srcs[0].numel())
        dsts = [torch.empty_like(s) for s in srcs]
        launch_gen(wrapper, "fold", srcs, dsts, ReductionOp.SUM, plan=plan,
                   workspace=ws).wait()
        torch.cuda.synchronize()
        compare(f"{wrapper.__name__} {name} on a faulted workspace", dsts,
                kgd.gen_device_ref(srcs, plan, ReductionOp.SUM))
    if not (torch.equal(flags, before[0]) and torch.equal(err, before[1])):
        raise AssertionError("a generated launch on the fold route touched "
                             "the workspace")


def phase_kernels_gen_device() -> None:
    """The generated device collectives against their plain version: every
    device program at n = 2, 4, 8 on every type it takes, the five ops
    turning with the type (NaNs for MAX/MIN, AVG on floating types only),
    bcast roots 0, n/2 and n-1, every other case in place, counts of
    nchunks x 37, each on the fold route; the ring, direct and bcast
    programs at n = 3, 5, 16 and 32 (rhd_r2 at 16 and 32), views with a
    storage offset, and in place at the main shape, on the fold route too;
    then int8 and fp8 wire programs with tail groups on the wire fold
    (n = 2, 3, 4, 8, the three wirings, qblock 8 to 256, AVG, MAX, in
    place, views at +1 and mixed offsets), and the wire plans that have
    no fold plan (qblock 512, runs of two units) on the layer kernel. A
    fold launch on a faulted workspace must neither raise nor touch it; a
    set error word must make the layer route raise."""
    import torch
    from ucc_tpu_torch import CollType, ReductionOp
    from ucc_tpu_torch.dsl import lower_device as ld
    from ucc_tpu_torch.kernels import ring_common as kc
    t0 = time.perf_counter()
    cases = 0
    entries = {"ring": 0, "gen": 0}
    for n in (2, 4, 8):
        progs = ld.device_programs(n, "int8") + [
            p for p in ld.device_programs(n, "fp8") if "qfp8" in p.name]
        for i, prog in enumerate(progs):
            for j, tname in enumerate(GEN_DTYPES):
                dtype = getattr(torch, tname)
                op = kc.OPS[(i + j) % len(kc.OPS)]
                if op == ReductionOp.AVG and not dtype.is_floating_point:
                    op = ReductionOp.SUM
                if prog.wire and dtype != torch.float32:
                    continue                # wire programs take f32 only
                root = [0, n // 2, n - 1][(i + j) % 3] \
                    if prog.coll == CollType.BCAST else 0
                srcs = make_inputs(n, prog.nchunks * 37, dtype, op,
                                   7000 + 100 * n + 10 * i + j)
                check_gen(prog, n, srcs, op, root, inplace=(i + j) % 2 == 1,
                          qmode=prog.wire)
                plan = ld.device_plan(prog, n, prog.nchunks * 37, root)
                entries["ring" if plan.ring else "gen"] += 1
                cases += 1
    # more team sizes: a ring, the direct exchange and both bcasts at n =
    # 3, 5, 16 and 32, halving-doubling at 16 and 32 (its deepest trees)
    for n in (3, 5, 16, 32):
        by_name = {p.name: p for p in ld.device_programs(n)}
        names = ["gen_ring_c2", f"gen_rhd_r{n}", "gen_bc_kn_r2",
                 "gen_bc_chain_c2"] + (["gen_rhd_r2"] if n >= 16 else [])
        for i, name in enumerate(names):
            prog = by_name[name]
            for k, dtype in enumerate((torch.float32, torch.bfloat16)):
                op = kc.OPS[(i + k + n) % len(kc.OPS)]
                root = [n // 2, n - 1][k] \
                    if prog.coll == CollType.BCAST else 0
                srcs = make_inputs(n, prog.nchunks * 37, dtype, op,
                                   7500 + 10 * n + i + k)
                check_gen(prog, n, srcs, op, root, inplace=k == 1)
                cases += 1
    # views with a storage offset: mixed offsets take the scalar path, one
    # offset for all a scalar head, then vectors
    for name in ("gen_ring_c2", "gen_rhd_r2", "gen_bc_kn_r2"):
        prog = next(p for p in ld.device_programs(5 if "ring" in name else 4)
                    if p.name == name)
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            for mixed in (True, False):
                check_gen_views(prog, prog.nranks, prog.nchunks * 4001,
                                dtype, mixed, 7900 + len(name))
                cases += 1
    # in place at the main shape
    by_name = {p.name: p for p in ld.device_programs(N_RANKS)}
    for name, root in (("gen_ring_c2", 0), ("gen_bc_kn_r2", 3)):
        prog = by_name[name]
        check_gen(prog, N_RANKS, make_inputs(
            N_RANKS, MAIN_COUNT, torch.float32, ReductionOp.SUM, 7990),
            ReductionOp.SUM, root, inplace=True)
        cases += 1
        torch.cuda.empty_cache()
    wire = layer = 0
    for n in (2, 4, 8):
        for qmode in ("int8", "fp8"):
            for rs, ag in ((qmode, qmode), (qmode, ""), ("", qmode)):
                prog = wire_direct(n, rs, ag)
                for qblock, ce in ((32, 40), (256, 256 * 3 + 17)):
                    srcs = make_inputs(n, n * ce, torch.float32,
                                       ReductionOp.SUM, 8000 + n + ce)
                    check_gen(prog, n, srcs, ReductionOp.SUM, qblock=qblock,
                              qmode=qmode, inplace=ce == 40,
                              route="wire fold")
                    wire += 1
    # AVG; MAX in the exact reduce round beside a wired gather round (wire
    # receives add whatever the op); qblock 8 and 37, one lane's value and
    # two, with partial groups; no NaNs: the reference's cast of a NaN to
    # int8 is not pinned
    for n, qmode, (rs, ag), op, qblock, ce in (
            (4, "int8", ("int8", "int8"), ReductionOp.AVG, 37, 100),
            (8, "fp8", ("", "fp8"), ReductionOp.MAX, 8, 44),
            (3, "fp8", ("fp8", "fp8"), ReductionOp.AVG, 64, 200)):
        srcs = make_inputs(n, n * ce, torch.float32, ReductionOp.SUM,
                           8100 + n)
        check_gen(wire_direct(n, rs, ag), n, srcs, op, qblock=qblock,
                  qmode=qmode, route="wire fold", inplace=n == 4)
        wire += 1
    # views at +1 (groups starting on a 16-byte boundary take vectors, the
    # rest scalars) and mixed offsets (every group scalar)
    for qmode in ("int8", "fp8"):
        for mixed in (True, False):
            check_wire_views(wire_direct(4, qmode, qmode), 4, 4 * 1031, 256,
                             qmode, mixed, 8200 + mixed)
            wire += 1
    # the layer kernel keeps the wire plans that have no fold plan: qblock
    # 512 (a group wider than a warp's), and wire runs of two units whose
    # unit is no multiple of qblock (groups that straddle units)
    for n, qmode in ((2, "int8"), (4, "fp8"), (8, "int8")):
        srcs = make_inputs(n, n * 600, torch.float32, ReductionOp.SUM,
                           8300 + n)
        check_gen(wire_direct(n, qmode, qmode), n, srcs, ReductionOp.SUM,
                  qblock=512, qmode=qmode, route="layer")
        srcs = make_inputs(n, 2 * n * 40, torch.float32, ReductionOp.SUM,
                           8400 + n)
        check_gen(wire_pairs(n, qmode), n, srcs, ReductionOp.SUM, qblock=32,
                  qmode=qmode, route="layer", inplace=n == 4)
        layer += 2
    cases += wire + layer
    entries["gen"] += wire + layer
    srcs = make_inputs(4, 4 * 4096, torch.float32, ReductionOp.SUM, 27)
    check_gen_flag_free(srcs)
    plan, wrapper, route = gen_route(wire_direct(4, "int8", "int8"), 4,
                                     srcs[0].numel(), qblock=512,
                                     qmode="int8")
    if route != "layer":
        raise AssertionError(f"qblock 512: route {route}, want layer")
    expect_fault(lambda: launch_gen(
        wrapper, route, srcs, [torch.empty_like(s) for s in srcs],
        ReductionOp.SUM, plan=plan, workspace=faulted_workspace()))
    log(f"kernels: {cases} generated-collective launches ({entries['ring']} "
        f"ring entry, {entries['gen']} general entry at n in 2,4,8; "
        f"{cases - wire - layer} on the fold route, {wire} on the wire "
        f"fold, {layer} on the layer kernel) bitwise equal to "
        f"gen_device_ref (every device program at n in 2,4,8 on "
        f"{'/'.join(GEN_DTYPES)}; ring, direct and bcast programs "
        f"at n in 3,5,16,32, rhd_r2 at 16 and 32; SUM/AVG/MAX/MIN/PROD with "
        f"NaN for MAX/MIN; bcast roots 0, n/2, n-1, bitwise the root's src; "
        f"counts nchunks x 37; in place, also at 8 x {MAIN_COUNT}; views at "
        f"+1 and mixed offsets; int8/fp8 wire plans at n in 2,3,4,8, the "
        f"three wirings, qblock 8, 32, 37, 64 and 256 with partial groups, "
        f"AVG, MAX, in place and views on the wire fold; qblock 512 and "
        f"runs of two units on the layer kernel) in "
        f"{time.perf_counter() - t0:.1f} s; fold launches on a faulted "
        f"workspace neither raise nor touch it, and a set error word makes "
        f"the layer route raise")


def check_wire_views(prog, n, count, qblock, qmode, mixed, seed) -> float:
    """A wire plan over views with a storage offset, as check_misaligned
    runs the allreduce, on the wire fold, bitwise against gen_device_ref."""
    import torch
    from ucc_tpu_torch.kernels import gen_device as kgd
    plan, wrapper, route = gen_route(prog, n, count, 0, qblock, qmode)

    def entry(srcs, dsts, op):
        return launch_gen(wrapper, "wire fold", srcs, dsts, op, plan=plan)

    entry.__name__ = f"{wrapper.__name__} {prog.name} {qmode}"
    if route != "wire fold":
        raise AssertionError(f"{entry.__name__}: route {route}, want wire "
                             "fold")
    return check_misaligned(entry, lambda s, op: kgd.gen_device_ref(
        s, plan, op), n, count, torch.float32, mixed, seed)


def ec_inputs(td, count, k, variant, seed):
    """k sources of `count` elements of torch dtype `td` on the card:
    random bytes for the integer types, normal values for the floats; the
    "logical" variant zeroes about a third of each, the "nan" variant puts
    NaNs (floats) into the first and last source."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    esz = torch.empty(0, dtype=td).element_size()
    srcs = []
    for _ in range(k):
        if td.is_floating_point:
            wide = torch.float64 if td == torch.float64 else torch.float32
            x = torch.randn(count, generator=g, device="cuda",
                            dtype=wide).to(td)
        else:
            x = torch.randint(0, 256, (count, esz), generator=g,
                              device="cuda", dtype=torch.uint8)
        if variant == "logical":
            zero = torch.rand(count, generator=g, device="cuda") < 0.3
            x[zero] = 0
        srcs.append(x if td.is_floating_point else x.view(td).reshape(-1))
    if variant == "nan" and td.is_floating_point and count > 3:
        srcs[-1][3] = float("nan")
        srcs[0][2] = float("nan")
    return srcs


def ec_dst(td, count):
    """An output of `count` elements filled with a byte pattern."""
    import torch
    dst = torch.empty(count, dtype=td, device="cuda")
    dst.view(torch.uint8).fill_(7)
    return dst


def check_ec(what, dst, srcs, count, dt, op, alpha=None) -> None:
    """One ec_reduce launch into dst against its plain version on the same
    tensors, bitwise."""
    import torch
    from ucc_tpu_torch.kernels import ec_reduce as ker
    want = ker.ec_reduce_ref(srcs, count, dt, op, alpha)
    dst.view(torch.uint8).fill_(7)
    ker.ec_reduce(dst, srcs, count, dt, op, alpha)
    torch.cuda.synchronize()
    if not bits_equal(dst[:count], want):
        raise AssertionError(f"ec_reduce {what} {dt.name} {op.name} "
                             f"k={len(srcs)} count={count} alpha={alpha}: "
                             "differs from the plain version")


def phase_kernels_ec() -> None:
    import torch
    from ucc_tpu_torch import DataType, ReductionOp, Status, UccError
    from ucc_tpu_torch.constants import dt_from_torch
    from ucc_tpu_torch.ec.cuda import EcCuda
    from ucc_tpu_torch.kernels import ec_reduce as ker
    t0 = time.perf_counter()
    cases = 0
    maxmin = (ReductionOp.MAX, ReductionOp.MIN)
    for ti, td in enumerate(ker.DTYPE_CODES):
        dt = dt_from_torch(td)
        ops = [op for op in ker.OPS
               if not (td.is_floating_point and op in ker.BITWISE)]
        for ci, count in enumerate((1, 7, 1000, (1 << 20) + 3)):
            pools = {v: ec_inputs(td, count, 9, v, 100 * ti + 10 * ci + j)
                     for j, v in enumerate(("plain", "logical", "nan"))}
            dst = ec_dst(td, count)
            for op in ops:
                variant = "logical" if op in ker.LOGICAL else \
                    "nan" if op in maxmin else "plain"
                for k in (1, 2, 3, 9):
                    for alpha in (None, 0.25):
                        check_ec("", dst, pools[variant][:k], count, dt, op,
                                 alpha)
                        cases += 1
    # views: every buffer at one offset (aligned, or one element in: a
    # scalar head, 16-byte vectors, a scalar tail), and mixed offsets (the
    # scalar path for the whole launch)
    views = {"aligned": lambda j: 0, "+1": lambda j: 1,
             "mixed": lambda j: j % 2}
    for ti, td in enumerate((torch.float32, torch.bfloat16, torch.int8,
                             torch.float64)):
        dt = dt_from_torch(td)
        count = (1 << 16) + 5
        for k in (1, 2, 9):
            bases = ec_inputs(td, count + 1, k + 1, "plain", 900 + ti + k)
            for kind, at in views.items():
                dst = bases[0][at(0):at(0) + count]
                srcs = [b[at(j):at(j) + count]
                        for j, b in enumerate(bases[1:], 1)]
                for op in (ReductionOp.SUM, ReductionOp.MAX):
                    check_ec(f"views {kind}", dst, srcs, count, dt, op)
                    cases += 1
    # strided sources at an odd element offset, through the executor
    ec = EcCuda()
    count, n_src2, stride = 1000, 8, 1003
    for td in (torch.float32, torch.bfloat16, torch.int8, torch.float64):
        dt = dt_from_torch(td)
        base = ec_inputs(td, 1 + stride * n_src2, 1, "plain", 7)[0][1:]
        src1 = ec_inputs(td, count, 1, "plain", 8)[0]
        esz = base.element_size()
        srcs = [src1] + [base[i * stride:i * stride + count]
                         for i in range(n_src2)]
        want = ker.ec_reduce_ref(srcs, count, dt, ReductionOp.SUM, 0.25)
        dst = ec_dst(td, count)
        t = ec.reduce_strided(dst, src1, base, stride * esz, n_src2, count,
                              dt, ReductionOp.SUM, 0.25)
        while ec.task_test(t) == Status.IN_PROGRESS:
            pass
        if t.array is not dst or not bits_equal(dst, want):
            raise AssertionError(f"reduce_strided {td} at an odd offset "
                                 "differs from the plain version")
        cases += 1
    # seven jobs of one reduce_multi_dst
    jobs = []
    for i in range(7):
        td = (torch.float32, torch.bfloat16, torch.int32)[i % 3]
        op = (ReductionOp.SUM, ReductionOp.MAX, ReductionOp.PROD)[i % 3]
        s1, s2 = ec_inputs(td, 4096 + 13 * i, 2, "nan", 30 + i)
        jobs.append(dict(dst=ec_dst(td, 4096 + 13 * i), src1=s1, src2=s2,
                         count=4096 + 13 * i, dt=dt_from_torch(td), op=op,
                         alpha=0.5 if i == 4 else None))
    t = ec.reduce_multi_dst(jobs)
    while ec.task_test(t) == Status.IN_PROGRESS:
        pass
    for j, d in zip(jobs, t.array):
        want = ker.ec_reduce_ref([j["src1"], j["src2"]], j["count"], j["dt"],
                                 j["op"], j["alpha"])
        if d is not j["dst"] or not bits_equal(d, want):
            raise AssertionError("reduce_multi_dst job differs from the "
                                 "plain version")
    cases += 7
    for call, status in (
            (lambda: ker.ec_reduce(ec_dst(torch.float32, 8),
                                   [ec_dst(torch.float32, 8)] * 10, 8,
                                   DataType.FLOAT32, ReductionOp.SUM),
             Status.ERR_INVALID_PARAM),
            (lambda: ker.ec_reduce(ec_dst(torch.float32, 8),
                                   [ec_dst(torch.float32, 8)] * 2, 8,
                                   DataType.FLOAT32, ReductionOp.BAND),
             Status.ERR_NOT_SUPPORTED)):
        try:
            call()
        except UccError as e:
            if e.status != status:
                raise
        else:
            raise AssertionError(f"ec_reduce did not raise {status.name}")
    log(f"kernels: {cases} ec_reduce launches bitwise equal to their plain "
        f"versions ({len(ker.DTYPE_CODES)} types x 11 ops, k in 1,2,3,9, "
        f"counts 1/7/1000/2^20+3, alpha None/0.25, NaN for MAX/MIN, views "
        f"aligned, at +1 and at mixed offsets, strided at an odd offset, "
        f"7-job multi_dst) in "
        f"{time.perf_counter() - t0:.1f} s; 10 sources and BAND on f32 "
        f"raise")


def attention_tolerance(dtype):
    """(rtol, atol) of the attention kernel against its plain version. f32:
    the reference's own (tests/test_ring_attention.py); the two sum the
    same products in another order and fold a block in key tiles or at
    once. bf16/f16: one ulp of the type (2^-7 relative for bf16, 2^-10 for
    f16) with atol 1e-3 near zero; both accumulate in f32 and differ only
    where the final rounding to the type does."""
    import torch
    if dtype == torch.float32:
        return 2e-4, 2e-5
    return (2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -10), 1e-3


def attention_inputs(n, h, h_kv, s, d, dtype, seed, q_mul=1.0):
    """Normal q, k and v blocks of n ranks, q times q_mul (8 peaks the
    softmax)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple([(torch.randn(heads, s, d, generator=g, device="cuda") *
                   mul).to(dtype) for _ in range(n)]
                 for heads, mul in ((h, q_mul), (h_kv, 1.0), (h_kv, 1.0)))


def check_attention(qs, ks, vs, causal, what, scale=None) -> float:
    """One launch of the attention kernel against its plain version on the
    same tensors, on the route its dtype chooses (tensor cores for f16 and
    bf16, CUDA cores for f32); returns the max abs difference. `scale`
    defaults to 1/sqrt(head dim)."""
    import torch
    from ucc_tpu_torch.kernels import ring_attention as ka
    if scale is None:
        scale = ka.default_scale(qs[0].shape[-1])
    fwd = ka.ring_flash_attention_fwd
    before = fwd.launches, fwd.tc_launches
    got = fwd(qs, ks, vs, scale, causal)
    torch.cuda.synchronize()
    tc = int(qs[0].dtype in ka.TENSOR_CORE_DTYPES)
    if (fwd.launches, fwd.tc_launches) != (before[0] + 1, before[1] + tc):
        raise AssertionError(f"{what}: took the wrong route (launches "
                             f"{before} -> {fwd.launches, fwd.tc_launches})")
    return compare_attention(
        got, ka.ring_flash_attention_ref(qs, ks, vs, scale, causal), what)


def compare_attention(got, want, what) -> float:
    """Each rank's kernel output finite and within attention_tolerance of
    the plain version's; returns the max abs difference."""
    import torch
    rtol, atol = attention_tolerance(got[0].dtype)
    err = 0.0
    for r, (a, b) in enumerate(zip(got, want)):
        a, b = a.float(), b.float()
        if not torch.isfinite(a).all():
            raise AssertionError(f"{what}: rank {r} has non-finite values")
        err = max(err, (a - b).abs().max().item())
        if not torch.allclose(a, b, rtol=rtol, atol=atol):
            raise AssertionError(f"{what}: rank {r} differs from the plain "
                                 f"version by up to {err} (rtol {rtol}, "
                                 f"atol {atol})")
    return err


def exact_attention(qs, ks, vs, scale, causal):
    """softmax(scale · q kᵀ) v of the whole sequence in float64 on the
    card, one K/V head's group of query heads at a time; per-rank blocks
    of float64 out."""
    import torch
    n, (h, s, d), h_kv = len(qs), qs[0].shape, ks[0].shape[0]
    g, seq = h // h_kv, n * s
    q, k, v = (torch.cat(b, dim=1).double() for b in (qs, ks, vs))
    out = torch.empty_like(q)
    later = torch.ones(seq, seq, dtype=torch.bool,
                       device=q.device).triu(1) if causal else None
    for j in range(h_kv):
        sc = (q[j * g:(j + 1) * g] * scale) @ k[j].T
        if causal:
            sc.masked_fill_(later, float("-inf"))
        out[j * g:(j + 1) * g] = sc.softmax(-1) @ v[j]
        del sc
    return list(out.split(s, dim=1))


def exact_margin(got, exact) -> float:
    """max |got - exact| / (atol + rtol·|exact|) at the f32 tolerance:
    above 1 misses it."""
    rtol, atol = attention_tolerance(got[0].dtype)
    return max(((a.double() - b).abs() / (atol + rtol * b.abs())).max()
               .item() for a, b in zip(got, exact))


#: how much further from the float64 result than the plain version an f32
#: kernel may be, where the plain version itself misses the tolerance
PLAIN_FACTOR = 2.0


def check_attention_exact(qs, ks, vs, causal, what) -> dict:
    """One f32 launch on the CUDA-core route held to the float64 result:
    within the f32 tolerance or, where the plain version (the JAX package's
    arithmetic) misses it too, within PLAIN_FACTOR times the plain
    version's margin. A peaked softmax puts float32's rounding of S at the
    tolerance: two float32 evaluations then differ by more than it (at the
    main widths with q x 8, the plain version itself is 1.18 tolerances
    from float64; tests/test_torch_attention_f32.py prints smaller cases'
    margins on the CPU). Returns the margins: kernel and plain version
    against float64, and kernel against the plain version."""
    import torch
    from ucc_tpu_torch.kernels import ring_attention as ka
    scale = ka.default_scale(qs[0].shape[-1])
    fwd = ka.ring_flash_attention_fwd
    before = fwd.launches, fwd.tc_launches
    got = fwd(qs, ks, vs, scale, causal)
    torch.cuda.synchronize()
    if (fwd.launches, fwd.tc_launches) != (before[0] + 1, before[1]):
        raise AssertionError(f"{what}: took the wrong route (launches "
                             f"{before} -> {fwd.launches, fwd.tc_launches})")
    if not all(torch.isfinite(o).all() for o in got):
        raise AssertionError(f"{what}: non-finite values")
    plain = ka.ring_flash_attention_ref(qs, ks, vs, scale, causal)
    exact = exact_attention(qs, ks, vs, scale, causal)
    margins = {"kernel_vs_float64": exact_margin(got, exact),
               "plain_vs_float64": exact_margin(plain, exact),
               "kernel_vs_plain": exact_margin(
                   got, [p.double() for p in plain])}
    if margins["kernel_vs_float64"] > max(
            1.0, PLAIN_FACTOR * margins["plain_vs_float64"]):
        raise AssertionError(f"{what}: further from the float64 result "
                             f"than the f32 tolerance and twice the plain "
                             f"version allow: {margins}")
    return margins


#: the attention phase's cases (n, h, h_kv, d, s_local, causal, dtype
#: name): every n, head layout, head dim and s_local with both maskings and
#: with f32 and bf16, plus f16, head dims 1 and 256 and a ragged 37; then
#: five put bf16 and f16 on the tensor cores at d 8 and 256 with ragged
#: s_local; the last six put f32 at n = 3, d 1, 37 (4-byte copies) and 256
#: (64-row CTAs), s_local 37 and 300 (query tiles of 128 rows, the last
#: ragged)
ATTENTION_CASES = (
    (1, 4, 4, 8, 3, False, "float32"),
    (1, 8, 2, 64, 100, True, "bfloat16"),
    (1, 32, 8, 128, 1024, False, "float32"),
    (2, 4, 4, 64, 1024, True, "bfloat16"),
    (2, 8, 2, 128, 3, False, "float32"),
    (2, 32, 8, 8, 100, True, "float32"),
    (2, 8, 2, 128, 100, True, "float16"),
    (8, 4, 4, 128, 100, False, "bfloat16"),
    (8, 8, 2, 8, 1024, True, "float32"),
    (8, 32, 8, 64, 3, True, "bfloat16"),
    (8, 32, 8, 128, 1024, False, "bfloat16"),
    (8, 4, 4, 128, 100, True, "float32"),
    (8, 8, 2, 64, 100, False, "float16"),
    (2, 4, 2, 256, 70, True, "float32"),
    (8, 4, 4, 1, 37, True, "bfloat16"),
    (2, 8, 2, 8, 37, True, "bfloat16"),
    (8, 4, 4, 8, 70, False, "float16"),
    (2, 4, 2, 256, 70, True, "bfloat16"),
    (1, 4, 4, 256, 100, True, "float16"),
    (8, 32, 8, 256, 37, True, "bfloat16"),
    (3, 4, 4, 1, 37, True, "float32"),
    (3, 32, 8, 37, 100, False, "float32"),
    (8, 8, 2, 37, 37, True, "float32"),
    (1, 4, 4, 256, 37, False, "float32"),
    (3, 8, 2, 256, 100, True, "float32"),
    (3, 4, 2, 128, 300, True, "float32"),
)
#: a peaked softmax (q x 8) at the main path's widths, on the tensor cores
#: and on the CUDA cores
PEAKED_CASE = (8, 32, 8, 128, 1024, True, "bfloat16")
PEAKED_F32_CASE = (8, 32, 8, 128, 1024, True, "float32")


def phase_kernels_attention() -> None:
    import torch
    from ucc_tpu_torch import Status, UccError
    from ucc_tpu_torch.fused_attention import ring_flash_attention
    from ucc_tpu_torch.kernels import ring_attention as ka
    t0 = time.perf_counter()
    errs = {}
    for i, (n, h, h_kv, d, s, causal, dname) in enumerate(ATTENTION_CASES):
        dtype = getattr(torch, dname)
        what = (f"ring_flash_attention_fwd n={n} h={h} h_kv={h_kv} d={d} "
                f"s_local={s} causal={causal} {dname}")
        err = check_attention(*attention_inputs(n, h, h_kv, s, d, dtype,
                                                60 + i), causal, what)
        errs[dname] = max(errs.get(dname, 0.0), err)
    n, h, h_kv, d, s, causal, dname = PEAKED_CASE
    peaked_err = check_attention(
        *attention_inputs(n, h, h_kv, s, d, getattr(torch, dname), 89,
                          q_mul=8.0), causal,
        f"ring_flash_attention_fwd peaked (q x 8) n={n} h={h} h_kv={h_kv} "
        f"d={d} s_local={s} {dname}")
    n, h, h_kv, d, s, causal, dname = PEAKED_F32_CASE
    peaked_f32 = check_attention_exact(
        *attention_inputs(n, h, h_kv, s, d, getattr(torch, dname), 85,
                          q_mul=8.0), causal,
        f"ring_flash_attention_fwd peaked (q x 8) n={n} h={h} h_kv={h_kv} "
        f"d={d} s_local={s} {dname}")
    # blocks at an element offset of one: the tensor-core kernel's 2-byte
    # loads, the f32 kernel's 4-byte copies
    def misaligned(t):
        return torch.empty(t.numel() + 1, dtype=t.dtype,
                           device=t.device)[1:].view(t.shape).copy_(t)
    for i, dname in enumerate(("bfloat16", "float32")):
        blocks = attention_inputs(2, 8, 2, 100, 128, getattr(torch, dname),
                                  88 - 5 * i)
        errs[f"{dname} misaligned"] = check_attention(
            *([misaligned(t) for t in b] for b in blocks), True,
            f"ring_flash_attention_fwd misaligned blocks n=2 h=8 h_kv=2 "
            f"d=128 s_local=100 {dname}")
    # a negative and a zero scale: the row max must follow the sign
    for dname, scale, seed in (("bfloat16", -0.125, 86),
                               ("float16", 0.0, 87),
                               ("float32", -0.125, 76),
                               ("float32", 0.0, 77)):
        errs[f"{dname} scale {scale}"] = check_attention(
            *attention_inputs(2, 8, 2, 100, 64, getattr(torch, dname),
                              seed), True,
            f"ring_flash_attention_fwd scale={scale} n=2 h=8 h_kv=2 d=64 "
            f"s_local=100 {dname}", scale=scale)
    try:
        ring_flash_attention(*attention_inputs(2, 5, 2, 16, 8, torch.float32,
                                               90))
    except ValueError as e:
        if "GQA" not in str(e):
            raise
    else:
        raise AssertionError("5 q heads over 2 k/v heads did not raise")
    try:
        ka.ring_flash_attention_fwd(
            *attention_inputs(2, 4, 4, 16, ka.MAX_HEAD_DIM + 1,
                              torch.float32, 91), 0.1, False)
    except UccError as e:
        if e.status != Status.ERR_NOT_SUPPORTED:
            raise
    else:
        raise AssertionError(f"head dim {ka.MAX_HEAD_DIM + 1} did not raise")
    log(f"kernels: {len(ATTENTION_CASES) + 7} ring_flash_attention_fwd "
        f"launches within tolerance of their plain versions, f32 on CUDA "
        f"cores and f16/bf16 on tensor cores (n in 1,2,3,8; (h, h_kv) in "
        f"(4,4),(8,2),(4,2),(32,8); d in 1,8,37,64,128,256; s_local in 3,"
        f"37,70,100,300,1024; causal both ways; f32/bf16/f16; max abs err "
        f"by dtype {errs}; peaked q x 8 at the main widths {peaked_err}; "
        f"TF32 matmul {torch.backends.cuda.matmul.allow_tf32}) in "
        f"{time.perf_counter() - t0:.1f} s; peaked f32 at the main widths "
        f"against float64: {peaked_f32}; mismatched heads raise "
        f"ValueError, head dim {ka.MAX_HEAD_DIM + 1} ERR_NOT_SUPPORTED")


#: Meta Llama 3 8B's attention widths (its config.json: hidden_size,
#: num_attention_heads, num_key_value_heads, head_dim) and its full
#: context (max_position_embeddings), sharded over N_RANKS
LLAMA3_8B = dict(dm=4096, heads=32, kv_heads=8, e=128)
CONTEXT = 8192


def main_path_attention(smi, ptxas) -> dict:
    """The GQA block's forward at LLAMA3_8B over CONTEXT tokens, causal,
    bf16, WARMUP + ITERS times with the launch counters zeroed just before:
    every launch must take the tensor-core route. Then its attention held
    against the plain version and SDPA, the kernel and SDPA timed in turns
    at these shapes, and the f32 route (CUDA cores) held and timed on the
    same projections in f32. Returns the kernel's record, with `ptxas`
    (registers and spills per instance) in it."""
    import torch
    import torch.nn.functional as F
    from ucc_tpu_torch.examples.long_context import (INIT_STD,
                                                     GqaRingAttentionBlock,
                                                     init_gqa_params)
    from ucc_tpu_torch.kernels import ring_attention as ka
    dm, h, h_kv, e = (LLAMA3_8B[k] for k in ("dm", "heads", "kv_heads", "e"))
    s_local = CONTEXT // N_RANKS
    g = torch.Generator(device="cuda").manual_seed(33)
    block = GqaRingAttentionBlock(
        init_gqa_params(dm, h, h_kv, e, generator=g,
                        dtype=torch.bfloat16, device="cuda"),
        h, h_kv, e, causal=True)
    # tokens scaled so q, k and v have unit variance, as after the model's
    # norm layer: x·w sums dm products of std x_std·INIT_STD
    x_std = 1.0 / (INIT_STD * dm ** 0.5)
    x = (torch.randn(1, CONTEXT, dm, generator=g, device="cuda") * x_std
         ).to(torch.bfloat16)
    xs = [t.contiguous() for t in x.split(s_local, dim=1)]
    fwd = ka.ring_flash_attention_fwd
    samples = []
    with torch.no_grad():
        fwd.launches = fwd.tc_launches = 0
        for i in range(WARMUP + ITERS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = block(xs)
            torch.cuda.synchronize()
            if i >= WARMUP:
                samples.append(time.perf_counter() - t0)
        launches, tc_launches = fwd.launches, fwd.tc_launches
        if launches != WARMUP + ITERS or tc_launches != launches:
            raise AssertionError(f"the GQA block launched "
                                 f"ring_flash_attention_fwd {launches} "
                                 f"times, {tc_launches} on the tensor "
                                 f"cores, want {WARMUP + ITERS} of both")
        if len(outs) != N_RANKS or any(
                o.shape != (1, s_local, dm) or o.dtype != torch.bfloat16 or
                not torch.isfinite(o).all() for o in outs):
            raise AssertionError("the GQA block's outputs are not finite "
                                 f"bf16 (1, {s_local}, {dm}) blocks")
        # the attention inside that forward, checked
        qs, ks, vs = block.project(xs)
        scale = ka.default_scale(e)
        attn = fwd(qs, ks, vs, scale, True)
        torch.cuda.synchronize()
        if not all(torch.equal(o, m) for o, m in zip(outs,
                                                     block.merge(attn, 1))):
            raise AssertionError("the GQA block's output is not its "
                                 "attention merged through wo")
        max_err = compare_attention(
            attn, ka.ring_flash_attention_ref(qs, ks, vs, scale, True),
            "GQA block attention")
        q, k, v = (torch.cat(t, dim=1)[None] for t in (qs, ks, vs))

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)

        lib = sdpa()[0].float()
        got = torch.cat(attn, dim=1).float()
        rtol, _ = attention_tolerance(torch.bfloat16)
        # SDPA rounds the probabilities to bf16 before P·V (2^-9 each, so
        # an element moves by up to 2^-9·max|v|) on top of the output's
        # rounding: atol 2^-8·max|v|
        sdpa_atol = 2.0 ** -8 * v.float().abs().max().item()
        sdpa_err = (got - lib).abs().max().item()
        if not torch.allclose(got, lib, rtol=rtol, atol=sdpa_atol):
            raise AssertionError(f"GQA block attention differs from "
                                 f"scaled_dot_product_attention by up to "
                                 f"{sdpa_err} (atol {sdpa_atol})")
        del lib, got
        # the kernel and SDPA in turns: kernel, SDPA, kernel, SDPA
        turns = [(cuda_ms(lambda: fwd(qs, ks, vs, scale, True), ITERS),
                  cuda_ms(sdpa, ITERS)) for _ in range(2)]
        ms = sum(t[0] for t in turns) / len(turns)
        library_ms = sum(t[1] for t in turns) / len(turns)
        plain_ms = cuda_ms(
            lambda: ka.ring_flash_attention_ref(qs, ks, vs, scale, True), 3)
        # the block's time outside the kernel, on the device: its
        # projections and folds, its merge through wo, and the whole forward
        # (p50 less this is the host's share)
        split = {"project_ms": cuda_ms(lambda: block.project(xs), ITERS),
                 "merge_ms": cuda_ms(lambda: block.merge(attn, 1), ITERS),
                 "block_device_ms": cuda_ms(lambda: block(xs), ITERS)}
        f32 = main_path_attention_f32(qs, ks, vs, scale,
                                      launches - tc_launches)
    # least work: the causal half of the S x S scores and of P·V, the
    # diagonal included (4·h·d flops a pair); least bytes: q, k, v read
    # and o written once
    bound, bound_by = bound_ms(
        N_RANKS * (2 * h + 2 * h_kv) * s_local * e * 2,
        4 * h * e * CONTEXT * (CONTEXT + 1) // 2, TENSOR16_FLOPS)
    samples.sort()
    p50 = samples[len(samples) // 2]
    log(f"main path GQA block (Llama 3 8B attention widths: dm {dm}, {h} "
        f"heads, {h_kv} KV heads, head dim {e}), bf16, causal, {CONTEXT} "
        f"tokens over {N_RANKS} ranks: forward p50 {p50 * 1e3:.3f} ms (p10 "
        f"{samples[len(samples) // 10] * 1e3:.3f}, max "
        f"{samples[-1] * 1e3:.3f}) over {ITERS} runs, "
        f"{CONTEXT / p50:.0f} tokens/s | launches {launches} | "
        f"ring_flash_attention_fwd {ms:.3f} ms, bound {bound:.4f} ms "
        f"({bound_by}), roofline share {bound / ms:.4f} | plain "
        f"{plain_ms:.3f} ms, max abs err {max_err} | SDPA {library_ms:.4f} "
        f"ms, max abs diff {sdpa_err} (atol {sdpa_atol:.4f}) | in turns "
        f"(kernel, SDPA) {turns} | {tc_launches} launches on the tensor "
        f"cores | device ms: project {split['project_ms']:.3f}, merge "
        f"{split['merge_ms']:.3f}, whole forward "
        f"{split['block_device_ms']:.3f} | card {smi}")
    log(f"ring_flash_attention_fwd f32 route (CUDA cores) on the same "
        f"projections in f32: {f32['ms']:.3f} ms, bound "
        f"{f32['bound_ms']:.4f} ms ({f32['bound_by']}), roofline share "
        f"{f32['bound_ms'] / f32['ms']:.4f} | max abs err "
        f"{f32['max_abs_err']} | plain {f32['plain_ms']:.3f} ms | SDPA f32 "
        f"{f32['library_ms']:.4f} ms | in turns (kernel, SDPA, SDPA, "
        f"kernel) {f32['turns']} | launches {f32['launches']} | card "
        f"{smi}")
    log(f"ptxas of {ka.SOURCE}: {json.dumps(ptxas)}")
    # the f16/bf16 route issues wgmma (HGMMA in SASS), the f32 route none
    wrong = [k for k, v in ptxas.items()
             if (v["hgmma"] > 0) != ("ring_flash_attn_tc_kernel" in k)]
    if wrong or not any("ring_flash_attn_tc_kernel" in k for k in ptxas):
        raise AssertionError(f"wgmma missing from a tensor-core instance or "
                             f"present in a CUDA-core one: {wrong}")
    return {
        "name": "ring_flash_attention_fwd", "route": "cuda",
        "source": f"ucc_tpu_torch/csrc/{ka.SOURCE}",
        "replaces": "ucc_tpu/fused_attention.py:44",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
        "library_ms": library_ms,
        "kernel_route": "tensor cores (wgmma), f16/bf16",
        "tc_launches": tc_launches, "f32_route": f32, "ptxas": ptxas,
        "block_p50_ms": p50 * 1e3, **split,
    }


def main_path_attention_f32(qs, ks, vs, scale, launches) -> dict:
    """The f32 route (ring_flash_attn_kernel, CUDA cores) on the main path's
    projections cast to f32: held against its plain version, timed in
    turns with SDPA in f32 (TF32 off) and beside its plain version, bound
    by f32 FMAs outside the tensor cores. `launches` is the route's count
    from the main path's run."""
    import torch
    import torch.nn.functional as F
    from ucc_tpu_torch.kernels import ring_attention as ka
    qs, ks, vs = ([t.float() for t in b] for b in (qs, ks, vs))
    n, (h, s_local, e), h_kv = len(qs), qs[0].shape, ks[0].shape[0]
    max_err = check_attention(qs, ks, vs, True, "f32 route, main shapes")
    q, k, v = (torch.cat(t, dim=1)[None] for t in (qs, ks, vs))

    def kernel():
        ka.ring_flash_attention_fwd(qs, ks, vs, scale, True)

    def sdpa():
        F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                       enable_gqa=True)

    # in turns: kernel, SDPA, SDPA, kernel
    turns = [cuda_ms(f, ITERS) for f in (kernel, sdpa, sdpa, kernel)]
    ms, library_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    plain_ms = cuda_ms(
        lambda: ka.ring_flash_attention_ref(qs, ks, vs, scale, True), 3)
    seq = n * s_local
    bound, bound_by = bound_ms(n * (2 * h + 2 * h_kv) * s_local * e * 4,
                               4 * h * e * seq * (seq + 1) // 2, F32_FLOPS)
    return {"name": "ring_flash_attention_fwd f32", "route": "cuda",
            "source": f"ucc_tpu_torch/csrc/{ka.SOURCE}",
            "replaces": "ucc_tpu/fused_attention.py:44",
            "kernel_route": "CUDA cores (f32 FMAs)", "launches": launches,
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": library_ms, "turns": turns}


def ptxas_start(source):
    """nvcc -Xptxas -v of one csrc source into a throwaway object, started
    in the background; ptxas_read parses its report."""
    from ucc_tpu_torch.kernels import build
    flags = [f for f in build.NVCC_FLAGS if f != "-shared"]
    stem = os.path.splitext(source)[0]
    obj = os.path.join(build.BUILD_DIR, f"ptxas_{stem}_{os.getpid()}.o")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    return obj, subprocess.Popen(
        [build.nvcc_path(), *flags, "-c", "-Xptxas", "-v", "-o", obj,
         os.path.join(build.CSRC, source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ptxas_read(started) -> dict:
    """{kernel instance: {registers, stack_frame, spill_stores,
    spill_loads, hgmma, ldg128, stg128, ffma, lds, lds128}} (bytes for the
    stack frame and the spills; hgmma counts the warpgroup
    tensor-core instructions in the object's SASS, by cuobjdump, ldg128
    and stg128 its 128-bit global loads and stores, ffma its f32 FMAs, lds
    its shared loads and lds128 the 128-bit ones among them) from
    ptxas_start's report; names demangled by cu++filt where the toolkit
    has it."""
    import re
    from ucc_tpu_torch.kernels import build
    obj, proc = started
    log_text, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -Xptxas -v failed:\n{log_text}")
    sass = subprocess.run(
        [os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump"),
         "-sass", obj], capture_output=True, text=True, check=True).stdout
    os.remove(obj)
    counts, name = {}, None
    patterns = {"hgmma": r"\bHGMMA\.", "ldg128": r"\bLDG\.E\S*\.128\b",
                "stg128": r"\bSTG\.E\S*\.128\b", "ffma": r"\bFFMA\b",
                "lds": r"\bLDS\b", "lds128": r"\bLDS\S*\.128\b"}
    for line in sass.splitlines():
        hit = re.search(r"Function : (\S+)", line)
        if hit:
            name = hit.group(1)
            counts[name] = dict.fromkeys(patterns, 0)
        elif name:
            for key, pat in patterns.items():
                if re.search(pat, line):
                    counts[name][key] += 1
    out, name = {}, None
    for line in log_text.splitlines():
        hit = re.search(r"Compiling entry function '([^']+)'", line)
        if hit:
            name = hit.group(1)
            out[name] = dict(counts.get(name, dict.fromkeys(patterns, 0)))
        hit = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                        r"stores, (\d+) bytes spill loads", line)
        if hit and name:
            out[name]["stack_frame"] = int(hit.group(1))
            out[name]["spill_stores"] = int(hit.group(2))
            out[name]["spill_loads"] = int(hit.group(3))
        hit = re.search(r"Used (\d+) registers", line)
        if hit and name:
            out[name]["registers"] = int(hit.group(1))
    filt = os.path.join(os.path.dirname(build.nvcc_path()), "cu++filt")
    if os.path.isfile(filt) and out:
        names = subprocess.run([filt], input="\n".join(out),
                               capture_output=True, text=True,
                               check=True).stdout.split("\n")
        # "void <unnamed>::kernel<__half, (int)128, ...>(<unnamed>::Args)"
        out = {re.sub(r"^void |<unnamed>::|\(anonymous namespace\)::|"
                      r"\(int\)", "", plain).rsplit("(", 1)[0]: v
               for plain, v in zip(names, out.values())}
    return out


#: the f32 and bf16 instances of a kernel templated on its element type,
#: demangled and as mangled (when the toolkit has no cu++filt)
BY_TYPE = (("<float>", "IfE"), ("<__nv_bfloat16>", "I13__nv_bfloat16E"))
#: the same instances of a kernel templated on its element type and PART,
#: its whole-walk ones (PART false, as cu++filt prints it: "(bool)0"; the
#: part instances of a team across processes are checked for spills with
#: the rest)
BY_TYPE_WHOLE = (("<float, (bool)0>", "IfLb0E"),
                 ("<__nv_bfloat16, (bool)0>", "I13__nv_bfloat16Lb0E"))
#: the flag-free kernels that move 16-byte vectors: source -> (kernel, its
#: f32 and bf16 instances); bcast.cu's and allgather.cu's are named by
#: element width; the five direct sources' whole-walk instances
DIRECT_KERNELS = {"ring_allreduce.cu": ("ring_allreduce_kernel",
                                        BY_TYPE_WHOLE),
                  "reduce_scatter.cu": ("reduce_scatter_kernel",
                                        BY_TYPE_WHOLE),
                  "gen_fold.cu": ("gen_fold_kernel", BY_TYPE),
                  "alltoall.cu": ("alltoall_kernel", BY_TYPE_WHOLE),
                  "bcast.cu": ("bcast_kernel", (
                      ("<4, (bool)0>", "ILi4ELb0E"),
                      ("<2, (bool)0>", "ILi2ELb0E"))),
                  "allgather.cu": ("allgather_kernel", (
                      ("<4, (bool)0>", "ILi4ELb0E"),
                      ("<2, (bool)0>", "ILi2ELb0E")))}


def check_direct_sass(source, info) -> None:
    """A flag-free kernel moves 16-byte vectors: its f32 and bf16
    instances (bcast.cu's and allgather.cu's 4- and 2-byte ones) must hold 128-bit global
    loads and stores (LDG.E.128, STG.E.128 in any cache variant) in their
    SASS."""
    kernel, instances = DIRECT_KERNELS[source]
    log(f"ptxas of {source}: {json.dumps(info)}")
    for names in instances:
        hits = [v for k, v in info.items() if any(
            f"{kernel}{t}" in k for t in names)]
        if not hits or not (hits[0]["ldg128"] and hits[0]["stg128"]):
            raise AssertionError(f"{kernel}{names[0]} has no 128-bit global "
                                 f"loads or stores: {hits}")


def check_spills(infos) -> None:
    """Report every kernel instance that spills registers to local memory
    or has a stack frame (nvcc -Xptxas -v's bytes: stack frame, spill
    stores, spill loads) in any source; no instance of a flag-free kernel
    may, as each thread keeps its vectors in flight (and gen_fold.cu its
    stack) in registers."""
    spills = {f"{src}: {k}": (v.get("stack_frame"), v.get("spill_stores"),
                              v.get("spill_loads"))
              for src, info in infos.items() for k, v in info.items()
              if v.get("stack_frame") or v.get("spill_stores") or
              v.get("spill_loads")}
    counts = {src: len(info) for src, info in infos.items()}
    log(f"ptxas: kernel instances per source {counts}; bytes of stack "
        f"frame, spill stores, spill loads: {spills}")
    direct = [k for k in spills if k.split(":")[0] in DIRECT_KERNELS]
    if direct:
        raise AssertionError(f"flag-free kernel instances spill or have a "
                             f"stack frame: {direct}")


#: instances of the wire fold with 4 or 8 values a lane (16-byte vectors)
#: and ec_reduce's vector kernel's f32 and bf16 SUM instances, demangled
#: or as mangled
WIRE_VECTOR_INSTANCE = r"(, [48]>|ELi[48]EE)"
EC_VECTOR_INSTANCES = (("ec_reduce_vec_kernel<float, 0>",
                        "ec_reduce_vec_kernelIfLi0EE"),
                       ("ec_reduce_vec_kernel<__nv_bfloat16, 0>",
                        "ec_reduce_vec_kernelI13__nv_bfloat16Li0EE"))


#: ec_reduce's f32, f16 and bf16 instances (the main path's types),
#: demangled or as mangled
EC_FLOAT_TYPES = ("<float,", "<__half,", "<__nv_bfloat16,", "IfLi",
                  "I6__halfLi", "I13__nv_bfloat16Li")


def check_wire_and_ec_sass(wire_info, ec_info) -> None:
    """The wire fold (gen_device.cu, 8 instances) keeps its leaves and its
    groups' values in registers: no instance may spill or have a stack
    frame. ec_reduce.cu has 108 instances of the scalar kernel and 108 of
    the vector kernel; its f32, f16 and bf16 ones may not spill or have a
    stack frame either, and the others that do are printed. The wire
    fold's instances of 4 and 8 values a lane and ec_reduce's vector f32
    and bf16 SUM instances must hold 128-bit global loads and stores
    (LDG.E.128, STG.E.128). Prints the wire fold's registers and
    ec_reduce's range of them."""
    import re
    wire = {k: v for k, v in wire_info.items() if "gen_wire_fold_kernel" in k}
    ec = {k: v for k, v in ec_info.items() if "ec_reduce" in k}
    regs = sorted(v.get("registers", 0) for v in ec.values()) or [0]

    def framed(v):
        return v.get("stack_frame") or v.get("spill_stores") or \
            v.get("spill_loads")

    others = sorted(k for k, v in ec.items() if framed(v) and not any(
        t in k for t in EC_FLOAT_TYPES))
    log("ptxas of the wire fold's instances (registers): " + "; ".join(
        f"{k}: {v.get('registers')}" for k, v in wire.items()) +
        f" | ec_reduce's {len(ec)} instances: {regs[0]}-{regs[-1]} "
        f"registers; its other instances with a stack frame or spill: "
        f"{others}")
    bad = [k for k, v in wire.items() if framed(v)] + [
        k for k, v in ec.items() if framed(v) and k not in others]
    if len(wire) != 8 or len(ec) != 216 or bad:
        raise AssertionError(f"want 8 wire fold and 216 ec_reduce instances "
                             f"(got {len(wire)}, {len(ec)}), none of the "
                             f"wire fold's or ec_reduce's f32/f16/bf16 with a "
                             f"stack frame or spill: {bad}")
    vec = [k for k in wire if re.search(WIRE_VECTOR_INSTANCE, k)]
    vec += [k for k in ec for names in EC_VECTOR_INSTANCES
            if any(t in k for t in names)]
    flat = [k for k in vec if not ({**wire, **ec}[k]["ldg128"] and
                                   {**wire, **ec}[k]["stg128"])]
    if len(vec) != 6 or flat:
        raise AssertionError(f"instances without 128-bit global loads or "
                             f"stores (want 6 to check, got {len(vec)}): "
                             f"{flat}")


def check_attention_f32_sass(info) -> None:
    """Every f32 instance of the attention kernel (the CUDA-core route,
    one per head dim and copy width) reads its operands with 128-bit shared
    loads (LDS.128) and keeps its register tiles without a stack frame or
    spill; prints each instance's registers and its FFMA and LDS counts
    (static, in the SASS)."""
    f32 = {k: v for k, v in info.items() if "ring_flash_attn_kernel" in k}
    log("ptxas of the f32 attention instances (registers, FFMA, LDS, "
        "LDS.128): " + "; ".join(
            f"{k}: {v.get('registers')}, {v['ffma']}, {v['lds']}, "
            f"{v['lds128']}" for k, v in f32.items()))
    bad = {k: v for k, v in f32.items()
           if not v["lds128"] or v.get("stack_frame") or
           v.get("spill_stores") or v.get("spill_loads")}
    if len(f32) != 10 or bad:
        raise AssertionError(f"f32 attention instances without LDS.128 or "
                             f"with a stack frame or spill (want 10 "
                             f"instances, got {len(f32)}): {bad}")


def make_job(n, params=None, **overrides):
    """n contexts (their libs made with *params* and the config
    *overrides*) and one team over them."""
    import ucc_tpu_torch as ucc
    world = ucc.ThreadOobWorld(n)
    libs = [ucc.init(params, **overrides) for _ in range(n)]
    ctxs = [None] * n
    errs = []

    def make(r):
        try:
            ctxs[r] = ucc.Context(libs[r],
                                  ucc.ContextParams(oob=world.endpoint(r)))
        except Exception as e:  # noqa: BLE001 - re-raised below
            errs.append(e)

    threads = [threading.Thread(target=make, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    if errs:
        raise errs[0]
    if any(t.is_alive() for t in threads):
        raise RuntimeError("context creation did not finish")
    return ctxs, make_team(ctxs)


def make_team(ctxs):
    """A team over every context (the TUNE variables are read here)."""
    import ucc_tpu_torch as ucc
    n = len(ctxs)
    tworld = ucc.ThreadOobWorld(n)
    teams = [c.create_team_post(ucc.TeamParams(oob=tworld.endpoint(r)))
             for r, c in enumerate(ctxs)]
    deadline = time.monotonic() + 120
    while True:
        sts = [t.create_test() for t in teams]
        for c in ctxs:
            c.progress()
        if all(s == ucc.Status.OK for s in sts):
            break
        bad = [s for s in sts if s.is_error]
        if bad:
            raise RuntimeError(f"team create failed: {bad[0]}")
        if time.monotonic() > deadline:
            raise RuntimeError("team create timed out")
    if teams[0].service_team is not None:
        # ids are agreed over a multi-rank service team (tl/shm)
        check_ids(teams, "a team over every context")
    return teams


#: the main path's runs: (collective, kernel it must launch, f32 elements
#: in and out per rank, root, seed)
MAIN_RUNS = (
    ("ALLREDUCE", "ring_allreduce_chunked", MAIN_COUNT, MAIN_COUNT, 0, 11),
    ("ALLREDUCE", "ring_allreduce_pass", SMALL_COUNT, SMALL_COUNT, 0, 12),
    ("REDUCE_SCATTER", "ring_reduce_scatter_chunked", MAIN_COUNT,
     MAIN_COUNT // N_RANKS, 0, 13),
    ("REDUCE_SCATTER", "ring_reduce_scatter_pass", SMALL_COUNT,
     SMALL_COUNT // N_RANKS, 0, 14),
    ("ALLGATHER", "ring_allgather_chunked", AG_MAIN_COUNT,
     AG_MAIN_COUNT * N_RANKS, 0, 15),
    ("ALLGATHER", "ring_allgather_pass", AG_SMALL_COUNT,
     AG_SMALL_COUNT * N_RANKS, 0, 16),
    ("BCAST", "ring_bcast_chunked", MAIN_COUNT, MAIN_COUNT, 3, 17),
    ("BCAST", "ring_bcast_pass", SMALL_COUNT, SMALL_COUNT, 0, 18),
    ("ALLTOALL", "ring_alltoall_chunked", MAIN_COUNT, MAIN_COUNT, 0, 19),
    ("ALLTOALL", "ring_alltoall_pass", SMALL_COUNT, SMALL_COUNT, 0, 20),
)

#: kernel -> (source, the TPU kernel it replaces, its plain version)
KERNELS = {
    "ring_allreduce_pass": ("ring_allreduce.cu", "ucc_tpu/tl/ring_dma.py:285",
                            "ring_allreduce_pass_ref"),
    "ring_allreduce_chunked": ("ring_allreduce.cu",
                               "ucc_tpu/tl/ring_dma.py:966",
                               "ring_allreduce_chunked_ref"),
    "ring_reduce_scatter_pass": ("reduce_scatter.cu",
                                 "ucc_tpu/tl/ring_dma.py:285",
                                 "ring_reduce_scatter_ref"),
    "ring_reduce_scatter_chunked": ("reduce_scatter.cu",
                                    "ucc_tpu/tl/ring_dma.py:1235",
                                    "ring_reduce_scatter_ref"),
    "ring_allgather_pass": ("allgather.cu", "ucc_tpu/tl/ring_dma.py:285",
                            "ring_allgather_ref"),
    "ring_allgather_chunked": ("allgather.cu",
                               "ucc_tpu/tl/ring_dma.py:1088",
                               "ring_allgather_ref"),
    "ring_bcast_pass": ("bcast.cu", "ucc_tpu/tl/ring_dma.py:460",
                        "ring_bcast_ref"),
    "ring_bcast_chunked": ("bcast.cu", "ucc_tpu/tl/ring_dma.py:533",
                           "ring_bcast_ref"),
    "ring_alltoall_pass": ("alltoall.cu", "ucc_tpu/tl/ring_dma.py:350",
                           "ring_alltoall_ref"),
    "ring_alltoall_chunked": ("alltoall.cu",
                              "ucc_tpu/tl/ring_dma.py:733",
                              "ring_alltoall_ref"),
}


def wrappers():
    """kernel name -> (wrapper, plain version taking (srcs, op, root))."""
    from ucc_tpu_torch.kernels import ring_allreduce as kr
    from ucc_tpu_torch.kernels import ring_bcast_a2a as kba
    from ucc_tpu_torch.kernels import ring_rs_ag as krs
    mods = {m.SOURCE: m for m in (kr, krs, kba)}
    mods[krs.RS_SOURCE] = krs
    mods[kba.A2A_SOURCE] = kba
    out = {}
    for name, (source, _, ref_name) in KERNELS.items():
        mod = mods[source]
        f = getattr(mod, ref_name)
        if "allgather" in name or "alltoall" in name:
            ref = (lambda f: lambda srcs, op, root: f(srcs))(f)
        elif "bcast" in name:
            ref = (lambda f: lambda srcs, op, root: f(srcs, root))(f)
        else:
            ref = (lambda f: lambda srcs, op, root: f(srcs, op))(f)
        out[name] = (getattr(mod, name), ref)
    return out


def run_main_path(ctxs, teams, coll, count, dst_count, root, seed):
    """Persistent `coll` (SUM where it reduces) of `count` f32 in and
    `dst_count` out per rank through the whole stack; bcast passes src
    alone, from `root`. Returns (per-round host seconds, srcs, dsts, alg
    name); a bcast's srcs are the root's data n times, its dsts the
    buffers."""
    import torch
    import ucc_tpu_torch as ucc
    n = len(teams)
    g = torch.Generator(device="cuda").manual_seed(seed)
    srcs = [torch.randn(count, generator=g, device="cuda") for _ in range(n)]
    f32 = ucc.DataType.FLOAT32
    if coll == "BCAST":
        dsts, srcs = srcs, [srcs[root].clone()] * n
        argses = [ucc.CollArgs(
            coll_type=ucc.CollType.BCAST, root=root,
            src=ucc.BufferInfo(dsts[r], count, f32),
            flags=ucc.CollArgsFlags.PERSISTENT) for r in range(n)]
    else:
        dsts = [torch.empty(dst_count, device="cuda") for _ in range(n)]
        argses = [ucc.CollArgs(
            coll_type=ucc.CollType[coll], op=ucc.ReductionOp.SUM,
            src=ucc.BufferInfo(srcs[r], count, f32),
            dst=ucc.BufferInfo(dsts[r], dst_count, f32),
            flags=ucc.CollArgsFlags.PERSISTENT) for r in range(n)]
    reqs = [teams[r].collective_init(argses[r]) for r in range(n)]
    alg = reqs[0].task.alg_name
    samples = time_rounds(ctxs, reqs, coll)
    return samples, srcs, dsts, alg


def time_rounds(ctxs, reqs, what):
    """WARMUP + ITERS rounds of the persistent requests (post every one,
    progress until none is in progress, each must be OK); the ITERS
    rounds' host seconds. Finalizes the requests."""
    import torch
    import ucc_tpu_torch as ucc

    def one_round():
        for rq in reqs:
            rq.post()
        deadline = time.monotonic() + 60
        while True:
            sts = [rq.test() for rq in reqs]
            if all(s != ucc.Status.IN_PROGRESS for s in sts):
                break
            for c in ctxs:
                c.progress()
            if time.monotonic() > deadline:
                raise RuntimeError(f"{what} did not complete in 60 s")
        bad = [s for s in sts if s != ucc.Status.OK]
        if bad:
            raise RuntimeError(f"{what} failed: {bad[0]}")

    for _ in range(WARMUP):
        one_round()
    samples = []
    for _ in range(ITERS):
        t0 = time.perf_counter()
        one_round()
        samples.append(time.perf_counter() - t0)
    for rq in reqs:
        rq.finalize()
    torch.cuda.synchronize()
    return samples


def check_main_result(coll, srcs, dsts, plain, root) -> None:
    """allreduce: every dst is torch.stack(srcs).sum(0); reduce_scatter:
    rank r's dst is its block of it (both within MAIN_RTOL/ATOL: another
    summation order); allgather: every dst is bitwise torch.cat(srcs);
    bcast: every buffer is bitwise the root's data; alltoall: rank r's dst
    is bitwise torch.cat of block r of every src. Every dst is bitwise the
    plain version."""
    import torch
    n = len(srcs)
    if coll == "ALLGATHER":
        compare("allgather vs torch.cat", dsts, [torch.cat(srcs)] * n)
    elif coll == "BCAST":
        compare(f"bcast from {root} vs the root's data", dsts,
                [srcs[root]] * n)
    elif coll == "ALLTOALL":
        compare("alltoall vs torch.cat of block r", dsts,
                alltoall_expected(srcs))
    else:
        total = torch.stack(srcs).sum(0)
        c = dsts[0].numel()
        for r, d in enumerate(dsts):
            want = total if coll == "ALLREDUCE" else total[r * c:(r + 1) * c]
            if not torch.isfinite(d).all():
                raise AssertionError(f"{coll} rank {r}: non-finite result")
            if not torch.allclose(d, want, rtol=MAIN_RTOL, atol=MAIN_ATOL):
                err = (d - want).abs().max().item()
                raise AssertionError(f"{coll} rank {r}: differs from "
                                     f"stack().sum(0) by {err}")
    compare(f"{coll} main path", dsts, plain)


def least_bytes(coll, n, count, dst_count, elem=4) -> int:
    """Bytes the collective must move over all n ranks, each input read
    once and each output written once: bcast reads the root's S bytes and
    writes n-1 copies (n·S); alltoall reads and writes n·S; the others
    read n srcs and write n dsts."""
    if coll == "BCAST":
        return n * count * elem
    if coll == "ALLTOALL":
        return 2 * n * count * elem
    return n * (count + dst_count) * elem


def bound_ms(nbytes, flops, flops_per_s=F32_FLOPS):
    """(ms, "bytes" or "operations"): the least time, the longer of moving
    `nbytes` at the HBM rate and doing the `flops` at `flops_per_s` (the
    f32 rate unless given)."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / flops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else \
        (by_ops, "operations")


#: collective -> (busbw / algbw as the nccl-tests count it, yardstick)
CONVENTIONS = {
    "ALLREDUCE": (2 * (N_RANKS - 1) / N_RANKS, "stack().sum(0)"),
    "REDUCE_SCATTER": ((N_RANKS - 1) / N_RANKS, "stack().sum(0)"),
    "ALLGATHER": ((N_RANKS - 1) / N_RANKS, "n x torch.cat"),
    "BCAST": (1.0, "(n-1) x copy_"),
    "ALLTOALL": ((N_RANKS - 1) / N_RANKS, "n x torch.cat of block r"),
}


def measure(coll, wrapper, ref, srcs, dst_count, root, bufs=None):
    """The kernel alone on the main path's inputs: bitwise against its
    plain version (max_abs_err), then timed with its workspace and
    pointer table built once, as the team's persistent launches reuse
    them (a bcast in place on the main path's buffers `bufs`, as the main
    path runs it); its plain version and one PyTorch call, timed in turns
    with the kernel, as yardsticks."""
    import torch
    from ucc_tpu_torch import ReductionOp
    from ucc_tpu_torch.kernels import ring_common as kc
    sum_ = ReductionOp.SUM
    n = len(srcs)
    if coll == "ALLGATHER":
        max_err = check_allgather(wrapper, lambda s: ref(s, sum_, 0), srcs)
    elif coll == "REDUCE_SCATTER":
        max_err = check_reduce_scatter(
            wrapper, lambda s, op: ref(s, op, 0), srcs, sum_)
    elif coll == "BCAST":
        max_err = check_bcast(wrapper, lambda s, r: ref(s, None, r), srcs,
                              root)
    elif coll == "ALLTOALL":
        max_err = check_alltoall(wrapper, lambda s: ref(s, None, 0), srcs)
    else:
        max_err = check_kernel(wrapper, lambda s, op: ref(s, op, 0), srcs,
                               sum_)
    ins, out = (bufs, bufs) if coll == "BCAST" else \
        (srcs, [torch.empty(dst_count, device="cuda") for _ in srcs])
    ws = kc.RingWorkspace(srcs[0].device)
    table = kc.make_ptr_table(ins, out)
    def kernel():
        return wrapper(ins, out, sum_, root=root, workspace=ws,
                       ptr_table=table)
    # kernel and library call in turns: library, kernel, kernel, library
    if coll == "ALLGATHER":
        def library():
            for o in out:
                torch.cat(srcs, out=o)
    elif coll == "ALLTOALL":
        b = srcs[0].numel() // n

        def library():
            for r, o in enumerate(out):
                torch.cat([s[r * b:(r + 1) * b] for s in srcs], out=o)
    elif coll == "BCAST":
        def library():
            for r, o in enumerate(out):
                if r != root:
                    o.copy_(srcs[root])
    else:
        def library():
            return torch.stack(srcs).sum(0)
    turns = [cuda_ms(f, 20) for f in (library, kernel, kernel, library)]
    yardstick = CONVENTIONS[coll][1]
    log(f"{wrapper.__name__} n={n} count={srcs[0].numel()} in turns "
        f"({yardstick}, kernel, kernel, {yardstick}): "
        f"{', '.join(f'{t:.4f}' for t in turns)} ms")
    ms, library_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    plain_ms = cuda_ms(lambda: ref(srcs, sum_, root), 3)
    return max_err, ms, plain_ms, library_ms


#: the generated device collectives on the main path: (collective, the
#: algorithm pinned by UCC_TL_TORCH_OPS_TUNE, the entry point it must
#: launch, f32 elements per rank, root, seed, lib overrides). "xla" is
#: tl/torch_ops's library-ops default, which launches no kernel.
GEN_RUNS = (
    ("ALLREDUCE", "gen_dev_ring_c2", "gen_device_ring", MAIN_COUNT, 0, 31),
    ("ALLREDUCE", "gen_dev_ring_c2", "gen_device_ring", SMALL_COUNT, 0, 32),
    ("ALLREDUCE", "gen_dev_rhd_r2", "gen_device_gen", MAIN_COUNT, 0, 33),
    ("ALLREDUCE", "gen_dev_rhd_r2", "gen_device_gen", SMALL_COUNT, 0, 34),
    ("ALLREDUCE", "gen_dev_rhd_r8", "gen_device_gen", MAIN_COUNT, 0, 35),
    ("ALLREDUCE", "gen_dev_rhd_r8", "gen_device_gen", SMALL_COUNT, 0, 36),
    ("BCAST", "gen_dev_bc_kn_r2", "gen_device_gen", MAIN_COUNT, 3, 37),
    ("BCAST", "gen_dev_bc_kn_r2", "gen_device_gen", SMALL_COUNT, 0, 38),
    ("BCAST", "gen_dev_bc_chain_c2", "gen_device_gen", MAIN_COUNT, 3, 39),
    ("BCAST", "gen_dev_bc_chain_c2", "gen_device_gen", SMALL_COUNT, 0, 40),
    ("ALLREDUCE", "xla", None, MAIN_COUNT, 0, 41),
    ("BCAST", "xla", None, MAIN_COUNT, 3, 42),
)
#: UCC_QUANT is a lib setting: the quantized program's run has its own libs
GEN_QUANT_RUNS = (
    ("ALLREDUCE", "gen_dev_qint8_direct", "gen_device_gen", MAIN_COUNT, 0,
     43),
)
#: the runs whose kernel numbers go into the kernels record, under these
#: names (every one on the fold route, csrc/gen_fold.cu)
GEN_RECORDS = {("gen_dev_ring_c2", MAIN_COUNT): "gen_device_ring",
               ("gen_dev_rhd_r2", MAIN_COUNT): "gen_device_gen",
               ("gen_dev_bc_kn_r2", MAIN_COUNT): "gen_device_gen bcast"}
GEN_REPLACES = {"gen_device_ring": "ucc_tpu/dsl/lower_device.py:525",
                "gen_device_gen": "ucc_tpu/dsl/lower_device.py:595",
                "gen_device_gen bcast": "ucc_tpu/dsl/lower_device.py:595"}


def measure_gen(coll, prog, srcs, root, bufs, qblock=256, qmode="",
                route="fold"):
    """The generated kernel alone on the main path's inputs, on *route*:
    bitwise against gen_device_ref (max_abs_err), then timed with its
    workspace and pointer table built once (a bcast in place on the main
    path's buffers `bufs`), in turns with one PyTorch call as a yardstick
    (library, kernel, kernel, library): torch.stack(srcs).sum(0) for
    allreduce, (n-1) x copy_ of the root's buffer for bcast; and its plain
    version."""
    import torch
    from ucc_tpu_torch import ReductionOp
    from ucc_tpu_torch.kernels import gen_device as kgd
    from ucc_tpu_torch.kernels import ring_common as kc
    sum_ = ReductionOp.SUM
    n = len(srcs)
    max_err = check_gen(prog, n, srcs, sum_, root, qblock=qblock,
                        qmode=qmode, route=route)
    plan, wrapper, _ = gen_route(prog, n, srcs[0].numel(), root, qblock,
                                 qmode)
    ins, out = (bufs, bufs) if coll == "BCAST" else \
        (srcs, [torch.empty_like(s) for s in srcs])
    ws = kc.RingWorkspace(srcs[0].device)
    table = kc.make_ptr_table(ins, out)

    def kernel():
        return wrapper(ins, out, sum_, plan=plan, workspace=ws,
                       ptr_table=table)

    if coll == "BCAST":
        def library():
            return [o.copy_(srcs[root]) for r, o in enumerate(out)
                    if r != root]
    else:
        def library():
            return torch.stack(srcs).sum(0)
    turns = [cuda_ms(f, 10) for f in (library, kernel, kernel, library)]
    log(f"{wrapper.__name__} {prog.name} n={n} count={srcs[0].numel()} "
        f"({route} route) in turns (library, kernel, kernel, library): "
        f"{', '.join(f'{t:.4f}' for t in turns)} ms")
    ms, library_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    plain_ms = cuda_ms(lambda: kgd.gen_device_ref(srcs, plan, sum_), 2)
    del ins, out, ws, table
    return max_err, ms, plain_ms, library_ms


def gen_bound(coll, n, count):
    """The least time: 2·n·S bytes for allreduce (n srcs read, n dsts
    written) with (n-1)·count adds, n·S for bcast."""
    if coll == "BCAST":
        return bound_ms(n * count * 4, 0)
    return bound_ms(2 * n * count * 4, (n - 1) * count)


def main_path_gen(smi) -> dict:
    """The generated device collectives and tl/torch_ops's library ops
    through the whole stack: init (UCC_GEN_DEVICE=y) -> contexts -> a team
    per run with UCC_TL_TORCH_OPS_TUNE=<coll>:@<alg>:inf -> persistent
    collective_init/post/test -> tl/torch_ops -> kernel B11. Each run's
    launch counters are zeroed just before and read just after; the entry
    point it names must have launched once per round, every launch on the
    fold route (csrc/gen_fold.cu), and no other gen entry point. Returns
    the records of GEN_RECORDS."""
    import torch
    import ucc_tpu_torch as ucc
    from ucc_tpu_torch.dsl import lower_device as ld
    from ucc_tpu_torch.kernels import gen_device as kgd
    from ucc_tpu_torch.tl import torch_ops
    rounds = WARMUP + ITERS
    counters = {"gen_device_ring": kgd.gen_device_ring,
                "gen_device_gen": kgd.gen_device_gen}
    records = {}
    progs = {ld.dev_alg_name(p): p
             for p in ld.device_programs(N_RANKS, "int8")}
    for runs, overrides in ((GEN_RUNS, {"GEN_DEVICE": "y"}),
                            (GEN_QUANT_RUNS, {"GEN_DEVICE": "y",
                                              "QUANT": "int8"})):
        ctxs, teams = make_job(N_RANKS, **overrides)
        for t in teams:
            t.destroy()
        for coll, alg, kname, count, root, seed in runs:
            os.environ["UCC_TL_TORCH_OPS_TUNE"] = f"{coll.lower()}:@{alg}:inf"
            teams = make_team(ctxs)
            for w in counters.values():
                w.launches = w.fold_launches = 0
            samples, srcs, dsts, got_alg = run_main_path(
                ctxs, teams, coll, count, count, root, seed)
            launches = {k: w.launches for k, w in counters.items()}
            folds = {k: w.fold_launches for k, w in counters.items()}
            for t in teams:
                t.destroy()
            if got_alg != alg:
                raise AssertionError(f"{coll} selected {got_alg}, not {alg}")
            want = {k: rounds if k == kname else 0 for k in counters}
            if launches != want or folds != want:
                raise AssertionError(f"{coll} via {alg}: launches {launches},"
                                     f" fold route {folds}, want {want} "
                                     f"for both")
            samples.sort()
            p50 = samples[len(samples) // 2]
            rooted = f" from root {root}" if coll == "BCAST" else ""
            head = (f"main path {coll}{rooted} {count} f32/rank via "
                    f"torch_ops/{alg}: p50 {p50 * 1e3:.3f} ms (p10 "
                    f"{samples[len(samples) // 10] * 1e3:.3f}, max "
                    f"{samples[-1] * 1e3:.3f}) over {ITERS} rounds")
            if kname is None:
                plain = [torch_ops.allreduce_ops(srcs, ucc.ReductionOp.SUM)
                         if coll == "ALLREDUCE" else
                         torch_ops.bcast_ops(srcs, root)] * N_RANKS
                check_main_result(coll, srcs, dsts, plain, root)
                log(f"{head} | library ops, no kernel | launches {launches} "
                    f"| card {smi}")
                del srcs, dsts, plain
                torch.cuda.empty_cache()
                continue
            prog = progs[alg]
            plan = ld.device_plan(prog, N_RANKS, count, root)
            plain = kgd.gen_device_ref(srcs, plan, ucc.ReductionOp.SUM)
            check_main_result(coll, srcs, dsts, plain, root)
            bufs = dsts if coll == "BCAST" else None
            del dsts, plain
            bound, bound_by = gen_bound(coll, N_RANKS, count)
            line = (f"{head} | launches {launches[kname]}, all on the fold "
                    f"route")
            if count == MAIN_COUNT:
                max_err, ms, plain_ms, library_ms = measure_gen(
                    coll, prog, srcs, root, bufs, qmode=prog.wire)
                library = "(n-1) x copy_" if coll == "BCAST" \
                    else "stack().sum(0)"
                line += (f" | {kname} {ms:.3f} ms, bound {bound:.4f} ms "
                         f"({bound_by}), roofline share {bound / ms:.4f} | "
                         f"plain {plain_ms:.3f} ms | {library} "
                         f"{library_ms:.3f} ms")
                record = GEN_RECORDS.get((alg, count))
                if record:
                    records[record] = {
                        "name": record, "route": "cuda",
                        "source": f"ucc_tpu_torch/csrc/{kgd.FOLD_SOURCE}",
                        "replaces": GEN_REPLACES[record],
                        "launches": launches[kname], "max_abs_err": max_err,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": bound_by, "library_ms": library_ms,
                    }
            log(f"{line} | card {smi}")
            del srcs, bufs
            torch.cuda.empty_cache()
        os.environ.pop("UCC_TL_TORCH_OPS_TUNE", None)
        for c in ctxs:
            c.destroy()
    return records


def wire_below_the_stack(smi) -> list:
    """The wire plans at the main path's size, through the wrapper: int8
    and fp8 edge-tagged direct exchanges of 16 Mi f32 per rank over 8 ranks
    (qblock 256), which take the wire fold; the layer kernel on the same
    plans, launched straight (the wrapper gives it only the plans without
    a fold plan); both bitwise against the plain version, with their error
    against the exact sum, and timed in turns with each other and with
    torch.stack(srcs).sum(0). Returns their kernels records (no registered
    candidate reaches a wire plan, so the main path launched neither)."""
    import torch
    from ucc_tpu_torch import ReductionOp
    from ucc_tpu_torch.kernels import gen_device as kgd
    from ucc_tpu_torch.kernels import ring_common as kc
    sum_ = ReductionOp.SUM
    records = []
    for qmode in ("int8", "fp8"):
        prog = wire_direct(N_RANKS, qmode, qmode)
        srcs = make_inputs(N_RANKS, MAIN_COUNT, torch.float32, sum_,
                           50 + len(qmode))
        plan, wrapper, route = gen_route(prog, N_RANKS, MAIN_COUNT, 0, 256,
                                         qmode)
        if route != "wire fold":
            raise AssertionError(f"edge-wire {qmode} direct exchange at the "
                                 f"main shape: route {route}, want wire fold")
        want = kgd.gen_device_ref(srcs, plan, sum_)
        fold_out = [torch.full_like(s, 7) for s in srcs]
        layer_out = [torch.full_like(s, 7) for s in srcs]
        fold_table = kc.make_ptr_table(srcs, fold_out)
        layer_table = kc.make_ptr_table(srcs, layer_out)
        ws = kc.RingWorkspace(srcs[0].device)
        stream = torch.cuda.current_stream()

        def fold():
            return wrapper(srcs, fold_out, sum_, plan=plan,
                           ptr_table=fold_table)

        def layer():
            return kgd._launch_layers("wire layers", srcs, layer_out, sum_,
                                      plan, stream, ws, layer_table)

        def library():
            return torch.stack(srcs).sum(0)

        launch_gen(wrapper, route, srcs, fold_out, sum_, plan=plan,
                   ptr_table=fold_table).wait()
        layer().wait()
        torch.cuda.synchronize()
        what = f"edge-wire {qmode} direct exchange {N_RANKS} x {MAIN_COUNT}"
        errs = {"wire fold": compare(f"{what} (wire fold)", fold_out, want),
                "layer": compare(f"{what} (layer kernel)", layer_out, want)}
        turns = [cuda_ms(f, 10) for f in (library, fold, layer, layer, fold,
                                          library)]
        ms = {"wire fold": (turns[1] + turns[4]) / 2,
              "layer": (turns[2] + turns[3]) / 2}
        library_ms = (turns[0] + turns[5]) / 2
        plain_ms = cuda_ms(lambda: kgd.gen_device_ref(srcs, plan, sum_), 2)
        exact = torch.stack([s.double() for s in srcs]).sum(0)
        rel = max(((d.double() - exact).abs().max() / exact.abs().max())
                  .item() for d in fold_out)
        # bytes: n srcs read, n dsts written; operations: the n - 1 adds
        # and 7 a value for each QDQ (|x|, max, divide, round, two clips,
        # decode)
        fp = kgd.fold_plan(plan)
        qdqs = fp.program(0)[1].count(kgd.S_QDQ)
        bound, bound_by = bound_ms(2 * N_RANKS * MAIN_COUNT * 4,
                                   (N_RANKS - 1 + 7 * qdqs) * MAIN_COUNT)
        log(f"{what} f32 (qblock 256) in turns (stack().sum(0), wire fold, "
            f"layer kernel, layer kernel, wire fold, stack().sum(0)): "
            f"{', '.join(f'{t:.4f}' for t in turns)} ms | wire fold "
            f"{ms['wire fold']:.4f} ms, layer kernel {ms['layer']:.3f} ms "
            f"(arena {plan.arena >> 20} MiB/rank), bound {bound:.4f} ms "
            f"({bound_by}), roofline shares {bound / ms['wire fold']:.4f} "
            f"and {bound / ms['layer']:.4f} | plain {plain_ms:.3f} ms | "
            f"both bitwise the plain version | max error {rel:.5f} of "
            f"max|sum| | card {smi}")
        for kroute, suffix in (("wire fold", ""), ("layer", " layer")):
            records.append({
                "name": f"gen_device_gen wire {qmode}{suffix}",
                "route": "cuda", "source": f"ucc_tpu_torch/csrc/{kgd.SOURCE}",
                "replaces": "ucc_tpu/dsl/lower_device.py:595",
                "kernel_route": kroute, "launches": 0,
                "max_abs_err": errs[kroute], "ms": ms[kroute],
                "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": bound_by, "library_ms": library_ms,
                "error_of_max_sum": rel})
        del srcs, want, fold_out, layer_out, exact, ws
        torch.cuda.empty_cache()
    return records


#: ucc_perftest's reducedt runs on the main path: (arguments, dtype,
#: sources, elements per source)
PERFTEST_REDUCEDT = (
    (["-d", "float32", "-o", "sum", "--nbufs", "2", "-b", "64M", "-e", "64M",
      "--json", "-F"], "FLOAT32", 2, 16 << 20),
    (["-d", "bfloat16", "-o", "sum", "--nbufs", "9", "-b", "32M", "-e",
      "32M", "--json", "-F"], "BFLOAT16", 9, 16 << 20),
    (["--nbufs", "2", "-b", "256K", "-e", "256K"], "FLOAT32", 2, 64 << 10),
)
PERFTEST_ALLREDUCE = ["-c", "allreduce", "-m", "cuda", "-p", "8",
                      "--persistent", "-b", "64M", "-e", "64M", "--json",
                      "-F"]


def run_perftest(argv, counters):
    """ucc_tpu_torch.tools.perftest.main(argv) with WARMUP + ITERS rounds,
    every launch counter zeroed just before and read just after; returns
    (launches by kernel, the JSON records it printed)."""
    import contextlib
    import io
    from ucc_tpu_torch.tools import perftest
    argv = [*argv, "-w", str(WARMUP), "-n", str(ITERS)]
    for w in counters.values():
        w.launches = 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = perftest.main(argv)
    launches = {k: w.launches for k, w in counters.items()}
    for line in out.getvalue().splitlines():
        log(f"perftest {' '.join(argv)} | {line}")
    if rc != 0:
        raise AssertionError(f"perftest {argv} exited {rc}")
    recs = [json.loads(x) for x in out.getvalue().splitlines()
            if x.startswith("{")]
    return launches, recs


def main_path_perftest(counters, smi) -> dict:
    """The perftest runs of the main path; returns ec_reduce's record, from
    the first reducedt run (2 f32 sources of 64 MiB)."""
    import torch
    from ucc_tpu_torch import DataType, ReductionOp, Status
    from ucc_tpu_torch.constants import dt_torch
    from ucc_tpu_torch.ec.cuda import EcCuda
    from ucc_tpu_torch.kernels import ec_reduce as ker
    rounds = WARMUP + ITERS
    sum_ = ReductionOp.SUM
    record = None
    for argv, dname, k, count in PERFTEST_REDUCEDT:
        launches, recs = run_perftest(["-c", "reducedt", "-m", "cuda", *argv],
                                      counters)
        stray = {n: v for n, v in launches.items()
                 if v and n != "ec_reduce"}
        if launches["ec_reduce"] != rounds or stray:
            raise AssertionError(f"perftest reducedt {argv}: launches "
                                 f"{launches}, want ec_reduce {rounds}")
        # perftest checks no result: the executor at this shape, bitwise
        dt = DataType[dname]
        srcs = ec_inputs(dt_torch(dt), count, k, "plain", 40 + k)
        want = ker.ec_reduce_ref(srcs, count, dt, sum_)
        ec = EcCuda()
        task = ec.reduce(None, srcs, count, dt, sum_)
        while ec.task_test(task) == Status.IN_PROGRESS:
            pass
        dst = task.array
        if not bits_equal(dst, want):
            raise AssertionError(f"EcCuda.reduce {dname} k={k} count={count}"
                                 " differs from the plain version")
        max_err = (dst.double() - want.double()).abs().nan_to_num(0).max()
        ms = cuda_ms(lambda: ker.ec_reduce(dst, srcs, count, dt, sum_), 20)
        plain_ms = cuda_ms(lambda: ker.ec_reduce_ref(srcs, count, dt, sum_),
                           3)
        library_ms = cuda_ms(lambda: torch.stack(srcs).sum(0), 20)
        bound, bound_by = bound_ms((k + 1) * count * dst.element_size(),
                                   (k - 1) * count)
        p50 = f"p50 {recs[0]['p50_us']:.1f} us, " if recs else ""
        log(f"main path perftest reducedt {dname} k={k} x {count} "
            f"elements: {p50}launches {launches['ec_reduce']} | ec_reduce "
            f"{ms:.4f} ms, bound {bound:.4f} ms ({bound_by}), roofline "
            f"share {bound / ms:.4f} | plain {plain_ms:.3f} ms | "
            f"stack().sum(0) {library_ms:.4f} ms | EcCuda result bitwise "
            f"the plain version | card {smi}")
        if record is None:
            record = {
                "name": "ec_reduce", "route": "cuda",
                "source": f"ucc_tpu_torch/csrc/{ker.SOURCE}",
                "replaces": "ucc_tpu/ec/tpu.py:64",
                "launches": launches["ec_reduce"],
                "max_abs_err": max_err.item(),
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": bound_by, "library_ms": library_ms,
            }
        del srcs, want, dst, task
        torch.cuda.empty_cache()
    launches, recs = run_perftest(PERFTEST_ALLREDUCE, counters)
    if launches["ring_allreduce_chunked"] != rounds:
        raise AssertionError(f"perftest allreduce: launches {launches}, "
                             f"want ring_allreduce_chunked {rounds}")
    log(f"main path perftest allreduce 8 ranks x 64 MiB via tl/ring_cuda "
        f"(pinned by UCC_TL_RING_CUDA_TUNE): p50 "
        f"{recs[0]['p50_us']:.1f} us, busbw {recs[0]['busbw_GBps']} GB/s, "
        f"launches {launches['ring_allreduce_chunked']} | card {smi}")
    torch.cuda.empty_cache()
    return record


# ---------------------------------------------------------------------------
# 3b. the default device TL's collective types (tl/torch_ops), tl/self
# ---------------------------------------------------------------------------

#: the default TL's runs: (collective, variant, root); every rank moves
#: 16 Mi f32 (allgather(v) and gather(v) gather 16 Mi from 2 Mi blocks,
#: scatter(v) and reduce_scatter(v) scatter 16 Mi into 2 Mi blocks)
DEFAULT_RUNS = (
    ("ALLREDUCE", "", 0), ("REDUCE", "", 3), ("BCAST", "", 3),
    ("ALLGATHER", "", 0), ("GATHER", "", 3), ("ALLGATHERV", "uneven", 0),
    ("GATHERV", "uneven", 3), ("ALLTOALL", "", 0),
    ("ALLTOALLV", "uneven", 0), ("REDUCE_SCATTER", "", 0),
    ("REDUCE_SCATTER", "total 16 Mi + 3", 0),
    ("REDUCE_SCATTERV", "uneven", 0), ("SCATTER", "", 3),
    ("SCATTERV", "uneven", 3), ("BARRIER", "", 0), ("FANIN", "", 3),
    ("FANOUT", "", 3),
)
#: what the runs that reduce are checked against: within this of float64
DEFAULT_RTOL = DEFAULT_ATOL = 1e-5


def uneven(total, n):
    """n counts of a ramp around total / n that sum to total."""
    step = total // n // (4 * n)
    counts = [total // n + (2 * r - (n - 1)) * step // 2 for r in range(n)]
    counts[0] += total - sum(counts)
    return counts


def displs_of(counts):
    out, acc = [], 0
    for c in counts:
        out.append(acc)
        acc += c
    return out


def default_case(coll, variant, root, n, g):
    """(every rank's CollArgs, the srcs, the result buffers, a function
    returning every rank's expected result (None: not compared) and, for
    the runs that reduce, the float64 values of the same elements)."""
    import torch
    import ucc_tpu_torch as ucc
    from ucc_tpu_torch.tl import torch_ops
    f32, C = ucc.DataType.FLOAT32, MAIN_COUNT
    B = C // n
    P = ucc.CollArgsFlags.PERSISTENT
    CT = ucc.CollType[coll]
    SUM = ucc.ReductionOp.SUM

    def randn(c):
        return torch.randn(c, generator=g, device="cuda")

    def bi(t, c=None):
        return ucc.BufferInfo(t, t.numel() if c is None else c, f32)

    def biv(t, counts):
        return ucc.BufferInfoV(t, counts, None, f32,
                               mem_type=ucc.MemoryType.CUDA)

    if coll in ("BARRIER", "FANIN", "FANOUT"):
        none = ucc.BufferInfo(None, 0, ucc.DataType.UINT8,
                              mem_type=ucc.MemoryType.CUDA)
        argses = [ucc.CollArgs(coll_type=CT, root=root, src=none, flags=P)
                  for _ in range(n)]
        return argses, [], [], lambda: ([None] * n, None)
    if coll in ("ALLREDUCE", "REDUCE"):
        srcs = [randn(C) for _ in range(n)]
        dsts = [torch.empty(C, device="cuda")
                if coll == "ALLREDUCE" or r == root else None
                for r in range(n)]
        argses = [ucc.CollArgs(coll_type=CT, op=SUM, root=root,
                               src=bi(srcs[r]),
                               dst=None if dsts[r] is None else bi(dsts[r]),
                               flags=P) for r in range(n)]

        def want():
            out = torch_ops.allreduce_ops(srcs, SUM)
            exact = torch.stack(srcs).double().sum(0)
            return ([out if d is not None else None for d in dsts],
                    [exact if d is not None else None for d in dsts])
        return argses, srcs, dsts, want
    if coll == "BCAST":
        bufs = [randn(C) for _ in range(n)]
        srcs = [bufs[root].clone()] * n
        argses = [ucc.CollArgs(coll_type=CT, root=root, src=bi(bufs[r]),
                               flags=P) for r in range(n)]
        return argses, srcs, bufs, \
            lambda: ([torch_ops.bcast_ops(srcs, root)] * n, None)
    if coll in ("ALLGATHER", "GATHER", "ALLGATHERV", "GATHERV"):
        counts = uneven(C, n) if variant else [B] * n
        srcs = [randn(c) for c in counts]
        receives = [coll.startswith("ALL") or r == root for r in range(n)]
        dsts = [torch.empty(C, device="cuda") if rc else None
                for rc in receives]
        argses = [ucc.CollArgs(
            coll_type=CT, root=root, src=bi(srcs[r]),
            dst=(biv(dsts[r], counts) if coll.endswith("V") else
                 None if dsts[r] is None else bi(dsts[r])), flags=P)
            for r in range(n)]
        return argses, srcs, dsts, lambda: ([
            torch.cat(srcs) if rc else None for rc in receives], None)
    if coll in ("ALLTOALL", "ALLTOALLV"):
        if variant:
            ramp = [c - B for c in uneven(C, n)]
            m = [[B + ramp[(i + j) % n] for j in range(n)] for i in range(n)]
        else:
            m = [[B] * n for _ in range(n)]
        srcs = [randn(C) for _ in range(n)]
        dsts = [torch.empty(C, device="cuda") for _ in range(n)]
        sd = [displs_of(m[i]) for i in range(n)]
        if variant:
            argses = [ucc.CollArgs(
                coll_type=CT, src=biv(srcs[r], m[r]),
                dst=biv(dsts[r], [m[i][r] for i in range(n)]), flags=P)
                for r in range(n)]
        else:
            argses = [ucc.CollArgs(coll_type=CT, src=bi(srcs[r]),
                                   dst=bi(dsts[r]), flags=P)
                      for r in range(n)]
        return argses, srcs, dsts, lambda: ([torch.cat([
            srcs[i][sd[i][p]:sd[i][p] + m[i][p]] for i in range(n)])
            for p in range(n)], None)
    if coll in ("REDUCE_SCATTER", "REDUCE_SCATTERV"):
        from ucc_tpu_torch.utils.mathutils import block_count, block_offset
        total = C + 3 if variant.startswith("total") else C
        if coll == "REDUCE_SCATTERV":
            counts = uneven(total, n)
            offs = displs_of(counts)
        else:
            counts = [block_count(total, n, r) for r in range(n)]
            offs = [block_offset(total, n, r) for r in range(n)]
        srcs = [randn(total) for _ in range(n)]
        dsts = [torch.empty(c, device="cuda") for c in counts]
        argses = [ucc.CollArgs(
            coll_type=CT, op=SUM, src=bi(srcs[r]),
            dst=(biv(dsts[r], counts) if coll.endswith("V") else
                 bi(dsts[r])), flags=P) for r in range(n)]

        def want():
            full = torch_ops.allreduce_ops(srcs, SUM)
            exact = torch.stack(srcs).double().sum(0)
            return ([full[o:o + c] for o, c in zip(offs, counts)],
                    [exact[o:o + c] for o, c in zip(offs, counts)])
        return argses, srcs, dsts, want
    # SCATTER, SCATTERV
    counts = uneven(C, n) if variant else [B] * n
    offs = displs_of(counts)
    src = randn(C)
    dsts = [torch.empty(c, device="cuda") for c in counts]
    argses = [ucc.CollArgs(
        coll_type=CT, root=root,
        src=None if r != root else (biv(src, counts) if variant
                                    else bi(src)),
        dst=bi(dsts[r]), flags=P) for r in range(n)]
    return argses, [src], dsts, lambda: ([
        src[o:o + c] for o, c in zip(offs, counts)], None)


def check_default(what, dsts, want, exact=None) -> None:
    """Every rank's result bitwise its expected one (for the runs that
    reduce, the same torch expression outside the stack) and, where
    *exact* gives the float64 values, finite and within
    DEFAULT_RTOL/ATOL of them."""
    import torch
    for r, (d, w) in enumerate(zip(dsts, want)):
        if w is None:
            continue
        if not bits_equal(d, w):
            raise AssertionError(f"{what} rank {r}: not bitwise its "
                                 "expected result")
        if exact is None:
            continue
        if not torch.isfinite(d).all():
            raise AssertionError(f"{what} rank {r}: non-finite result")
        if not torch.allclose(d.double(), exact[r], rtol=DEFAULT_RTOL,
                              atol=DEFAULT_ATOL):
            err = (d.double() - exact[r]).abs().max().item()
            raise AssertionError(f"{what} rank {r}: {err} off the float64 "
                                 "reduction")


def p50_line(samples) -> str:
    samples = sorted(samples)
    return (f"p50 {samples[len(samples) // 2] * 1e3:.3f} ms (p10 "
            f"{samples[len(samples) // 10] * 1e3:.3f}, max "
            f"{samples[-1] * 1e3:.3f}) over {ITERS} rounds")


def main_path_defaults(smi, counters, ring_p50) -> None:
    """tl/torch_ops as the default device TL and tl/self: 8 contexts, one
    team per case, persistent requests through the whole stack, every
    kernel launch counter zeroed before each run and required to stay 0
    (library ops, no kernel):
    - every collective type of tl/xla's table at 16 Mi f32 per rank by the
      default selection, which must be torch_ops's ``xla`` (``short`` for
      the buffer-less three, whose message size is 0, as the reference's);
    - ``ring`` (pinned by UCC_TL_TORCH_OPS_TUNE) on SUM and AVG at 16 Mi;
    - ``short`` at 1 KiB for allreduce, bcast, allgather and alltoall;
    - bfloat16 PROD at 8 x 4096 (the repaired rounding) within rtol 1e-2
      of the float64 product;
    - a 1-rank team: allreduce and bcast of CUDA tensors through tl/self,
      and the README's quick start in the port.
    Prints each run's p50 beside the card; for reduce_scatter, allgather
    and alltoall also tl/ring_cuda's p50 at the same shape, from the
    pinned runs above (*ring_p50*)."""
    import torch
    import ucc_tpu_torch as ucc
    from ucc_tpu_torch.tl import torch_ops
    n = N_RANKS
    ctxs, teams = make_job(n)

    def zero():
        for w in counters.values():
            w.launches = 0

    def launched():
        return {k: w.launches for k, w in counters.items() if w.launches}

    g = torch.Generator(device="cuda").manual_seed(60)
    for coll, variant, root in DEFAULT_RUNS:
        argses, srcs, dsts, want = default_case(coll, variant, root, n, g)
        zero()
        reqs = [teams[r].collective_init(a) for r, a in enumerate(argses)]
        algs = {rq.task.alg_name for rq in reqs}
        teams_of = {type(rq.task).__module__ for rq in reqs}
        expect = "short" if not srcs else "xla"
        if algs != {expect} or teams_of != {torch_ops.__name__}:
            raise AssertionError(f"{coll} selected {algs} of {teams_of}, "
                                 f"not torch_ops/{expect}")
        samples = time_rounds(ctxs, reqs, coll)
        if launched():
            raise AssertionError(f"{coll} launched kernels: {launched()}")
        what = f"default {coll}{' ' + variant if variant else ''}" + (
            f" from root {root}" if argses[0].root else "")
        expected, exact = want()
        check_default(what, dsts, expected, exact)
        size = "16 Mi f32/rank" if srcs else "no buffers"
        line = f"{what} {size} via torch_ops/{expect}: {p50_line(samples)}"
        key = (coll, variant)
        if key in ring_p50:
            line += (f" | tl/ring_cuda at the same shape (pinned run above) "
                     f"p50 {ring_p50[key] * 1e3:.3f} ms")
        checked = "none (no buffers)" if not srcs else "byte for byte" \
            if exact is None else \
            "bitwise the same torch expression, within 1e-5 of float64"
        log(f"{line} | results {checked} | card {smi}")
        del argses, srcs, dsts, reqs, expected, exact
        torch.cuda.empty_cache()
    for t in teams:
        t.destroy()

    # ring, pinned
    os.environ["UCC_TL_TORCH_OPS_TUNE"] = "allreduce:@ring:inf"
    teams = make_team(ctxs)
    os.environ.pop("UCC_TL_TORCH_OPS_TUNE")
    for op in ("SUM", "AVG"):
        srcs = [torch.randn(MAIN_COUNT, generator=g, device="cuda")
                for _ in range(n)]
        dsts = [torch.empty(MAIN_COUNT, device="cuda") for _ in range(n)]
        rop = ucc.ReductionOp[op]
        reqs = [teams[r].collective_init(ucc.CollArgs(
            coll_type=ucc.CollType.ALLREDUCE, op=rop,
            src=ucc.BufferInfo(srcs[r], MAIN_COUNT, ucc.DataType.FLOAT32),
            dst=ucc.BufferInfo(dsts[r], MAIN_COUNT, ucc.DataType.FLOAT32),
            flags=ucc.CollArgsFlags.PERSISTENT)) for r in range(n)]
        if {rq.task.alg_name for rq in reqs} != {"ring"}:
            raise AssertionError("the ring pin did not select ring")
        zero()
        samples = time_rounds(ctxs, reqs, f"ring {op}")
        if launched():
            raise AssertionError(f"ring {op} launched kernels: {launched()}")
        plain = torch_ops.allreduce_ring_ops(srcs, rop)
        exact = torch.stack(srcs).double().sum(0) / (n if op == "AVG" else 1)
        for r, d in enumerate(dsts):
            if not bits_equal(d, plain):
                raise AssertionError(f"ring {op} rank {r}: not bitwise "
                                     "allreduce_ring_ops")
            if not torch.allclose(d.double(), exact, rtol=DEFAULT_RTOL,
                                  atol=DEFAULT_ATOL):
                raise AssertionError(f"ring {op} rank {r}: off float64")
        log(f"ring ALLREDUCE {op} 16 Mi f32/rank via torch_ops/ring "
            f"(pinned by UCC_TL_TORCH_OPS_TUNE): {p50_line(samples)} | "
            f"bitwise allreduce_ring_ops, within 1e-5 of float64 | "
            f"card {smi}")
        del srcs, dsts, plain, exact, reqs
        torch.cuda.empty_cache()
    for t in teams:
        t.destroy()

    # short at 1 KiB and the repaired bf16 PROD, by the default selection
    teams = make_team(ctxs)
    small = 256                                   # 1 KiB of f32
    for coll, root in (("ALLREDUCE", 0), ("BCAST", 3), ("ALLGATHER", 0),
                       ("ALLTOALL", 0)):
        count = small // n if coll == "ALLGATHER" else small
        srcs = [torch.randn(count, generator=g, device="cuda")
                for _ in range(n)]
        srcs[root][5] = -0.0
        bufs = [s.clone() for s in srcs]
        dsts = bufs if coll == "BCAST" else [
            torch.empty(small, device="cuda") for _ in range(n)]
        f32 = ucc.DataType.FLOAT32
        reqs = [teams[r].collective_init(ucc.CollArgs(
            coll_type=ucc.CollType[coll], op=ucc.ReductionOp.SUM, root=root,
            src=ucc.BufferInfo(bufs[r], count, f32),
            dst=None if coll == "BCAST" else ucc.BufferInfo(dsts[r], small,
                                                           f32),
            flags=ucc.CollArgsFlags.PERSISTENT)) for r in range(n)]
        if {rq.task.alg_name for rq in reqs} != {"short"}:
            raise AssertionError(f"short {coll}: selected "
                                 f"{ {rq.task.alg_name for rq in reqs} }")
        zero()
        samples = time_rounds(ctxs, reqs, f"short {coll}")
        if launched():
            raise AssertionError(f"short {coll} launched {launched()}")
        b = small // n
        want = {"ALLREDUCE": [torch_ops.short_fold_ops(
                    srcs, ucc.ReductionOp.SUM)] * n,
                "BCAST": [srcs[root]] * n,
                "ALLGATHER": [torch.cat(srcs)] * n,
                "ALLTOALL": [torch.cat([s[p * b:(p + 1) * b] for s in srcs])
                             for p in range(n)]}[coll]
        check_default(f"short {coll}", dsts, want)
        checked = {"ALLREDUCE": "the left fold short_fold_ops",
                   "BCAST": "the root's bits, -0.0 kept"}.get(
                       coll, "the expected layout")
        log(f"short {coll} 1 KiB/rank via torch_ops/short (default below "
            f"4 KiB on a GPU): {p50_line(samples)} | bitwise {checked} | "
            f"card {smi}")
    for seed in range(3):
        gb = torch.Generator(device="cuda").manual_seed(seed)
        srcs = [(1 + 0.3 * torch.randn(4096, generator=gb, device="cuda"))
                .to(torch.bfloat16) for _ in range(n)]
        dsts = [torch.empty_like(s) for s in srcs]
        bf = ucc.DataType.BFLOAT16
        reqs = [teams[r].collective_init(ucc.CollArgs(
            coll_type=ucc.CollType.ALLREDUCE, op=ucc.ReductionOp.PROD,
            src=ucc.BufferInfo(srcs[r], 4096, bf),
            dst=ucc.BufferInfo(dsts[r], 4096, bf),
            flags=ucc.CollArgsFlags.PERSISTENT)) for r in range(n)]
        if {rq.task.alg_name for rq in reqs} != {"xla"}:
            raise AssertionError("bf16 PROD did not select xla")
        samples = time_rounds(ctxs, reqs, "bf16 PROD")
        exact = torch.stack(srcs).double().prod(0)
        worst = max(((d.double() - exact).abs() / exact.abs())
                    .nan_to_num(float("inf")).max().item() for d in dsts)
        if not all(torch.allclose(d.double(), exact, rtol=1e-2, atol=0)
                   for d in dsts):
            raise AssertionError(f"bf16 PROD seed {seed}: worst relative "
                                 f"error {worst}, above 1e-2")
        log(f"bf16 PROD 8 x 4096 (1 + 0.3 N(0,1), seed {seed}) via "
            f"torch_ops/xla: worst relative error {worst:.5f} of the "
            f"float64 product (rtol 1e-2) | {p50_line(samples)} | "
            f"card {smi}")
    for t in teams:
        t.destroy()
    for c in ctxs:
        c.destroy()
    one_rank_self(smi, counters)


#: the README's quick start, in the port (tests/test_torch_self.py holds
#: the same text to the README)
QUICK_START = """
import numpy as np, ucc_tpu_torch

lib  = ucc_tpu_torch.init()
ctx  = ucc_tpu_torch.Context(lib)                      # no OOB -> 1-rank world
team = ctx.create_team(ucc_tpu_torch.TeamParams())

src = np.arange(4, dtype=np.float32); dst = np.zeros_like(src)
req = team.collective_init(ucc_tpu_torch.CollArgs(
    coll_type=ucc_tpu_torch.CollType.ALLREDUCE,
    src=ucc_tpu_torch.BufferInfo(src, 4, ucc_tpu_torch.DataType.FLOAT32),
    dst=ucc_tpu_torch.BufferInfo(dst, 4, ucc_tpu_torch.DataType.FLOAT32),
    op=ucc_tpu_torch.ReductionOp.SUM))
req.post(); req.wait()
"""


def one_rank_self(smi, counters) -> None:
    """A 1-rank context and team on the card: allreduce of 16 Mi f32 CUDA
    tensors and a bcast of them (src alone) through tl/self, the team's
    service team tl/self's, and the README's quick start."""
    import torch
    import ucc_tpu_torch as ucc
    ctx = ucc.Context(ucc.init())
    team = ctx.create_team(ucc.TeamParams())
    if team.service_team is None or team.service_team.NAME != "self":
        raise AssertionError("a 1-rank team has no tl/self service team")
    src = torch.randn(MAIN_COUNT, device="cuda")
    dst = torch.empty_like(src)
    keep = src.clone()
    f32 = ucc.DataType.FLOAT32
    for coll, args in (
            ("ALLREDUCE", ucc.CollArgs(
                coll_type=ucc.CollType.ALLREDUCE, op=ucc.ReductionOp.SUM,
                src=ucc.BufferInfo(src, MAIN_COUNT, f32),
                dst=ucc.BufferInfo(dst, MAIN_COUNT, f32),
                flags=ucc.CollArgsFlags.PERSISTENT)),
            ("BCAST", ucc.CollArgs(
                coll_type=ucc.CollType.BCAST, root=0,
                src=ucc.BufferInfo(src, MAIN_COUNT, f32),
                flags=ucc.CollArgsFlags.PERSISTENT))):
        for w in counters.values():
            w.launches = 0
        req = team.collective_init(args)
        if req.task.alg_name != "self":
            raise AssertionError(f"1-rank {coll} selected "
                                 f"{req.task.alg_name}, not self")
        samples = time_rounds([ctx], [req], f"1-rank {coll}")
        if any(w.launches for w in counters.values()):
            raise AssertionError(f"1-rank {coll} launched a kernel")
        if not bits_equal(src, keep) or (coll == "ALLREDUCE" and
                                         not bits_equal(dst, keep)):
            raise AssertionError(f"1-rank {coll}: not the src's bits")
        log(f"1-rank {coll} 16 Mi f32 CUDA tensors via self: "
            f"{p50_line(samples)} | dst bitwise src | card {smi}")
    team.destroy()
    ctx.destroy()
    scope = {}
    exec(QUICK_START, scope)
    if scope["req"].test() != ucc.Status.OK or \
            scope["req"].task.alg_name != "self" or \
            not (scope["dst"] == scope["src"]).all():
        raise AssertionError("the README's quick start failed in the port")
    scope["team"].destroy()
    scope["ctx"].destroy()
    log("README quick start in the port (1-rank world, numpy buffers): OK "
        "via self")


# ---------------------------------------------------------------------------
# 5. training: the in-graph API (ops over a RankMesh) and the steps on it
# ---------------------------------------------------------------------------

#: the training phase's mesh: one sequence a dp rank, its 4096 tokens over
#: 4 sp ranks (8192 tokens a step)
TRAIN_MESH = {"dp": 2, "sp": 4}
TRAIN_SEQ = 4096
#: SGD's learning rate in the training phase. At dm 1024 on the CPU (the
#: same init and token scales) lr 1.0 lowers the loss 1.6 % a step, far
#: above the f32 mean's rounding, and 10 and 100 still descend
TRAIN_LR = 1.0
#: steps checked (loss falls, replicas bitwise), then steps timed
TRAIN_STEPS, TRAIN_TIMED = 3, 5
#: a step's averaged gradient against the dense single-rank gradient of the
#: global mean loss, max |difference| over max |dense|: both are float32
#: (TF32 off) sums over 8192 tokens x 4096 features in other orders; at
#: dm 1024 on the CPU they differ by 4e-7 to 1.2e-6, so 1e-4 leaves room
#: for the card's summation orders and 4x the width
GRAD_RTOL = 1e-4
#: the examples against their reference_* functions: the JAX tests' own
#: float32 tolerance (tests/test_pipeline_parallel.py, test_moe_ep.py)
EXAMPLE_RTOL, EXAMPLE_ATOL = 2e-4, 2e-5
#: Meta Llama 3 8B's MLP widths (config.json: intermediate_size) and
#: Mixtral 8x7B's expert widths (num_local_experts, hidden_size,
#: intermediate_size)
LLAMA3_8B_MLP = 14336
MIXTRAL_EXPERTS = dict(n=8, dm=4096, hidden=14336)
#: the examples pin tl/ring_cuda for their allreduces and alltoalls
EXAMPLE_TUNE = "allreduce,alltoall:@ring_cuda:inf"
EXAMPLE_RUNS = 3


class pinned:
    """UCC_TL_RING_CUDA_TUNE set while the teams of a mesh are made."""

    def __init__(self, tune):
        self.tune = tune

    def __enter__(self):
        os.environ["UCC_TL_RING_CUDA_TUNE"] = self.tune

    def __exit__(self, *exc):
        os.environ.pop("UCC_TL_RING_CUDA_TUNE", None)


def zero(counters) -> None:
    for c in counters.values():
        c.launches = 0
    counters["ring_flash_attention_fwd"].tc_launches = 0


def launched(counters) -> dict:
    return {k: c.launches for k, c in counters.items() if c.launches}


def median_ms(samples) -> float:
    return sorted(samples)[len(samples) // 2] * 1e3


def dense_grads(loss_fn, params):
    """The loss and its gradient with respect to every weight, on one rank
    over the whole batch."""
    import torch
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in params.items()}
    loss = loss_fn(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in params])
    return loss.item(), dict(zip(params, grads))


def causal_softmax_av(q, k, v):
    """softmax(q kᵀ / sqrt(d), causal) v over (..., seq, d), in float32."""
    import torch
    seq = q.shape[-2]
    s = q @ k.transpose(-1, -2) / q.shape[-1] ** 0.5
    s = s.masked_fill(~torch.ones(seq, seq, dtype=torch.bool,
                                  device=q.device).tril(), float("-inf"))
    return s.softmax(-1) @ v


def check_grads(what, got, want) -> float:
    """max |got - want| / max |want| over the weights, within GRAD_RTOL."""
    worst = 0.0
    for name, w in want.items():
        err = ((got[name] - w).abs().max() / w.abs().max()).item()
        worst = max(worst, err)
        if not err <= GRAD_RTOL:
            raise AssertionError(f"{what}: the averaged {name} gradient is "
                                 f"{err} (of max |dense|) from the dense "
                                 f"gradient, above {GRAD_RTOL}")
    return worst


def check_replicas(what, params) -> None:
    import torch
    for name, reps in params.items():
        if not all(torch.equal(r, reps[0]) for r in reps[1:]):
            raise AssertionError(f"{what}: the replicas of {name} differ")


def run_steps(what, step, w, xs, ys, dense, counters):
    """TRAIN_STEPS steps, the launch counters zeroed just before: each
    step's replicas bitwise equal, the loss falling step by step; the first
    step's averaged gradients against `dense` (loss, grads) and its loss
    against the dense loss. Returns (weights, losses, grad error,
    launches)."""
    import torch
    zero(counters)
    losses, err = [], None
    step.keep_grads = True
    for i in range(TRAIN_STEPS):
        out, w = step(w, xs, ys)
        if not all(torch.equal(v, out[0]) for v in out):
            raise AssertionError(f"{what}: the ranks' losses differ")
        check_replicas(what, w)
        losses.append(out[0].item())
        if i == 0:
            err = check_grads(what, {k: g[0] for k, g in step.grads.items()},
                              dense[1])
            if abs(losses[0] - dense[0]) > 1e-5 * abs(dense[0]):
                raise AssertionError(f"{what}: loss {losses[0]}, dense "
                                     f"{dense[0]}")
            step.keep_grads, step.grads = False, None
    launches = launched(counters)
    if not all(b < a for a, b in zip(losses, losses[1:])) or \
            not all(abs(v) < float("inf") for v in losses):
        raise AssertionError(f"{what}: the loss did not fall at lr "
                             f"{TRAIN_LR}: {losses}")
    return w, losses, err, launches


def timed_steps(step, w, xs, ys, n):
    """n steps with the split marks on; (weights, {part: [seconds]})."""
    import torch
    step.timed = True
    parts = {}
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, w = step(w, xs, ys)
        torch.cuda.synchronize()
        parts.setdefault("step", []).append(time.perf_counter() - t0)
        for k, v in step.last.items():
            parts.setdefault(k, []).append(v)
    step.timed = False
    return w, parts


def gqa_training(smi, counters) -> dict:
    """The GQA train step at Llama 3 8B's attention widths over a dp 2 x
    sp 4 mesh, f32, causal: TRAIN_STEPS checked steps with the gradient
    AVG on the default TL, TRAIN_TIMED timed ones, then the same with
    tl/ring_cuda pinned for the AVG (B2 must launch). Returns the numbers
    the kernels record and PERF.md take."""
    import torch
    from ucc_tpu_torch.examples import long_context as lc
    from ucc_tpu_torch.fused_attention import ring_flash_attention
    from ucc_tpu_torch.kernels import ring_attention as ka
    from ucc_tpu_torch.mesh import RankMesh
    dm, h, h_kv, e = (LLAMA3_8B[k] for k in ("dm", "heads", "kv_heads", "e"))
    batch = TRAIN_MESH["dp"]
    tokens = batch * TRAIN_SEQ
    g = torch.Generator(device="cuda").manual_seed(44)
    params = lc.init_gqa_params(dm, h, h_kv, e, generator=g, device="cuda")
    # tokens scaled as main_path_attention scales them
    x_std = 1.0 / (lc.INIT_STD * dm ** 0.5)
    x = torch.randn(batch, TRAIN_SEQ, dm, generator=g, device="cuda") * x_std
    y = torch.randn(batch, TRAIN_SEQ, dm, generator=g, device="cuda") * 0.1

    def dense_loss(w):
        def heads(t, n):
            return t.reshape(batch, TRAIN_SEQ, n, e).transpose(1, 2)
        q = heads(x @ w["wq"], h)
        k = heads(x @ w["wk"], h_kv).repeat_interleave(h // h_kv, 1)
        v = heads(x @ w["wv"], h_kv).repeat_interleave(h // h_kv, 1)
        a = causal_softmax_av(q, k, v).transpose(1, 2).reshape(
            batch, TRAIN_SEQ, h * e)
        return ((a @ w["wo"] - y) ** 2).mean()

    t0 = time.perf_counter()
    dense = dense_grads(dense_loss, params)
    torch.cuda.empty_cache()
    spec = ("dp", "sp")
    fwd = ka.ring_flash_attention_fwd
    out = {}
    for alg, tune in (("xla", None), ("ring_cuda", "allreduce:@ring_cuda:inf")):
        if tune:
            with pinned(tune):
                mesh = RankMesh(TRAIN_MESH)
                mesh.teams(lc.JOINT)
        else:
            mesh = RankMesh(TRAIN_MESH)
        step = lc.make_gqa_train_step(mesh, h, h_kv, e, lr=TRAIN_LR)
        xs, ys = mesh.shard(x, spec), mesh.shard(y, spec)
        w = lc.replicate(params, mesh)
        w, losses, err, launches = run_steps(
            f"GQA step ({alg} gradient AVG)", step, w, xs, ys, dense,
            counters)
        f32 = launches.get("ring_flash_attention_fwd", 0) - fwd.tc_launches
        if f32 <= 0 or fwd.tc_launches:
            raise AssertionError(f"the GQA step launched the f32 attention "
                                 f"route {f32} times ({fwd.tc_launches} on "
                                 f"the tensor cores)")
        if (alg == "ring_cuda") != ("ring_allreduce_chunked" in launches):
            raise AssertionError(f"the gradient AVG via {alg} launched "
                                 f"{launches}")
        torch.cuda.reset_peak_memory_stats()
        w, parts = timed_steps(step, w, xs, ys, TRAIN_TIMED)
        peak = torch.cuda.max_memory_allocated()
        out[alg] = {"losses": losses, "grad_err": err, "launches": launches,
                    "f32_launches": f32,
                    **{f"{k}_p50_ms": median_ms(v) for k, v in parts.items()},
                    "peak_bytes": peak}
        if alg == "xla":
            # the forward kernel alone, at the step's shapes: one launch a
            # sp ring, f32 route
            with torch.no_grad():
                qs = [lc.gqa_fold(t @ w["wq"][r], h, e)
                      for r, t in enumerate(xs)]
                ks = [lc.gqa_fold(t @ w["wk"][r], h_kv, e)
                      for r, t in enumerate(xs)]
                vs = [lc.gqa_fold(t @ w["wv"][r], h_kv, e)
                      for r, t in enumerate(xs)]
            rings = mesh.groups("sp")
            scale = ka.default_scale(e)
            out[alg]["fwd_kernel_ms"] = cuda_ms(lambda: [fwd(
                [qs[r] for r in grp], [ks[r] for r in grp],
                [vs[r] for r in grp], scale, True) for grp in rings], 10)
            # the attention's forward and backward (the per-query-rank
            # recompute) alone, on the device
            leaves = [t.requires_grad_() for t in qs + ks + vs]
            cots = [torch.randn_like(q) for q in qs]
            out[alg]["attn_fwd_bwd_ms"] = cuda_ms(
                lambda: torch.autograd.grad(ring_flash_attention(
                    qs, ks, vs, causal=True, mesh=mesh, axis_name="sp"),
                    leaves, cots), 3)
            del qs, ks, vs, leaves, cots
        del w, xs, ys, step
        mesh.destroy()
        torch.cuda.empty_cache()
    xla, ring = out["xla"], out["ring_cuda"]
    log(f"training GQA step (Llama 3 8B attention widths: dm {dm}, {h} "
        f"heads, {h_kv} KV heads, head dim {e}), f32, causal, TF32 off, "
        f"mesh dp {TRAIN_MESH['dp']} x sp {TRAIN_MESH['sp']}, batch {batch} "
        f"x {TRAIN_SEQ} tokens, lr {TRAIN_LR}: losses {xla['losses']} "
        f"(falling; replicas bitwise equal every step) | first step's "
        f"averaged gradients vs the dense single-rank gradient: max err "
        f"{xla['grad_err']:.3e} of max |dense| (rtol {GRAD_RTOL}), loss "
        f"{dense[0]} dense | launches {xla['launches']} (f32 route "
        f"{xla['f32_launches']}) | card {smi}")
    log(f"training GQA step p50 {xla['step_p50_ms']:.3f} ms over "
        f"{TRAIN_TIMED} steps, {tokens / xla['step_p50_ms'] * 1e3:.0f} "
        f"tokens/s: forward {xla['forward_p50_ms']:.3f} ms (the attention "
        f"kernel {xla['fwd_kernel_ms']:.3f} ms of it on the device, 2 "
        f"launches), backward {xla['backward_p50_ms']:.3f} ms (the "
        f"attention's recompute backward "
        f"{xla['attn_fwd_bwd_ms'] - xla['fwd_kernel_ms']:.3f} ms of it on "
        f"the device: {xla['attn_fwd_bwd_ms']:.3f} ms forward and backward "
        f"less the kernel), gradient "
        f"AVG {xla['grad_avg_p50_ms']:.3f} ms via xla / "
        f"{ring['grad_avg_p50_ms']:.3f} ms via ring_cuda (step p50 "
        f"{ring['step_p50_ms']:.3f} ms; launches {ring['launches']}), "
        f"update {xla['update_p50_ms']:.3f} ms | peak memory "
        f"{xla['peak_bytes'] / 2**30:.2f} GiB (ring_cuda "
        f"{ring['peak_bytes'] / 2**30:.2f}) | phase "
        f"{time.perf_counter() - t0:.1f} s | card {smi}")
    return out


def mha_training(smi, counters) -> dict:
    """The MHA train step: 32 heads of 128, batch 2 x 4096 tokens over
    dp 2 x sp 4, f32, causal; checked as the GQA step (gradients against
    the dense single-rank gradient)."""
    import torch
    from ucc_tpu_torch.examples import long_context as lc
    from ucc_tpu_torch.mesh import RankMesh
    h, d = LLAMA3_8B["heads"], LLAMA3_8B["e"]
    batch = TRAIN_MESH["dp"]
    g = torch.Generator(device="cuda").manual_seed(45)
    params = lc.init_params(h, d, generator=g, device="cuda")
    # q = x·wq sums d products of std x_std·INIT_STD: unit variance
    x_std = 1.0 / (lc.INIT_STD * d ** 0.5)
    x = torch.randn(batch, h, TRAIN_SEQ, d, generator=g, device="cuda") * \
        x_std
    y = torch.randn(batch, h, TRAIN_SEQ, d, generator=g, device="cuda") * 0.1

    def dense_loss(w):
        q, k, v = (torch.einsum("bhsd,hde->bhse", x, w[n])
                   for n in ("wq", "wk", "wv"))
        out = torch.einsum("bhse,hed->bhsd", causal_softmax_av(q, k, v),
                           w["wo"])
        return ((out - y) ** 2).mean()

    dense = dense_grads(dense_loss, params)
    spec = ("dp", None, "sp")
    with pinned(EXAMPLE_TUNE):
        mesh = RankMesh(TRAIN_MESH)
        mesh.teams(lc.JOINT)
    step = lc.make_train_step(mesh, lr=TRAIN_LR)
    xs, ys = mesh.shard(x, spec), mesh.shard(y, spec)
    w, losses, err, launches = run_steps(
        "MHA step", step, lc.replicate(params, mesh), xs, ys, dense, counters)
    _, parts = timed_steps(step, w, xs, ys, EXAMPLE_RUNS)
    mesh.destroy()
    p50 = median_ms(parts["step"])
    log(f"training MHA step ({h} heads of {d}), f32, causal, mesh dp 2 x "
        f"sp 4, batch {batch} x {TRAIN_SEQ} tokens, lr {TRAIN_LR}: losses "
        f"{losses} (falling, replicas bitwise), gradient max err "
        f"{err:.3e} of max |dense| | p50 {p50:.3f} ms over {EXAMPLE_RUNS} "
        f"steps (forward {median_ms(parts['forward']):.3f}, backward "
        f"{median_ms(parts['backward']):.3f}, gradient AVG "
        f"{median_ms(parts['grad_avg']):.3f} via ring_cuda) | launches "
        f"{launches} | card {smi}")
    return {"p50_ms": p50, "launches": launches}


def example_p50(fn, runs=EXAMPLE_RUNS):
    """(last result, p50 ms of `runs` calls on the host clock, synchronised)."""
    import torch
    samples = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
    return res, median_ms(samples)


def check_close(what, got, want) -> float:
    import torch
    err = (got - want).abs().max().item()
    if got.shape != want.shape or not torch.isfinite(got).all() or \
            not torch.allclose(got, want, rtol=EXAMPLE_RTOL,
                               atol=EXAMPLE_ATOL):
        raise AssertionError(f"{what}: max abs diff {err} from its "
                             f"reference (rtol {EXAMPLE_RTOL}, atol "
                             f"{EXAMPLE_ATOL})")
    return err


def dp_tp_training(smi, counters) -> dict:
    """One DP x TP step at Llama 3 8B's MLP widths (4096 -> 14336), dp 2 x
    tp 4, 2 x 2048 tokens, against the dense single-rank step: the new
    weights equal w - lr·(dense gradient) up to GRAD_RTOL of lr·max|grad|
    and the update's rounding (2 ulp of max|w|)."""
    import torch
    import torch.nn.functional as F
    from ucc_tpu_torch.examples import dp_tp_training as dt
    from ucc_tpu_torch.mesh import RankMesh
    dm, hid, tokens = LLAMA3_8B["dm"], LLAMA3_8B_MLP, 4096
    g = torch.Generator(device="cuda").manual_seed(46)
    params = dt.init_params(dm, hid, generator=g, device="cuda")
    x = torch.randn(tokens, dm, generator=g, device="cuda")
    y = torch.randn(tokens, dm, generator=g, device="cuda")
    _, grads = dense_grads(lambda w: ((F.gelu(x @ w["w1"], approximate="tanh")
                                       @ w["w2"] - y) ** 2).mean(), params)
    with pinned(EXAMPLE_TUNE):
        mesh = RankMesh({"dp": 2, "tp": 4})
        mesh.teams("dp")
        mesh.teams("tp")
    step = dt.make_train_step(mesh, lr=TRAIN_LR)
    args = (mesh.shard(params["w1"], dt.W1_SPEC),
            mesh.shard(params["w2"], dt.W2_SPEC),
            mesh.shard(x, dt.X_SPEC), mesh.shard(y, dt.X_SPEC))
    zero(counters)
    (w1s, w2s, losses), p50 = example_p50(lambda: step(*args))
    launches = launched(counters)
    errs = []
    for name, new, spec in (("w1", w1s, dt.W1_SPEC), ("w2", w2s, dt.W2_SPEC)):
        old, gd = params[name], grads[name]
        err = (mesh.unshard(new, spec) - (old - TRAIN_LR * gd)).abs().max()
        limit = TRAIN_LR * GRAD_RTOL * gd.abs().max() + \
            2 * torch.finfo(torch.float32).eps * old.abs().max()
        if not err <= limit:
            raise AssertionError(f"DP x TP step: {name} is {err.item()} "
                                 f"from the dense update (limit "
                                 f"{limit.item()})")
        errs.append(err.item() / (TRAIN_LR * gd.abs().max().item()))
    mesh.destroy()
    log(f"training DP x TP step (Llama 3 8B MLP widths {dm} -> {hid}), "
        f"f32, dp 2 x tp 4, {tokens} tokens: loss {losses[0].item()} | new "
        f"weights vs the dense update: max err {max(errs):.3e} of "
        f"lr·max|grad| | p50 {p50:.3f} ms over {EXAMPLE_RUNS} steps | "
        f"launches {launches} | card {smi}")
    return {"p50_ms": p50, "launches": launches}


def pipeline_run(smi, counters) -> dict:
    """8 stages of 4096 (gelu(x @ w)), 8 microbatches of 512 tokens,
    against reference_pipeline."""
    import torch
    from ucc_tpu_torch.examples import pipeline_parallel as pp
    from ucc_tpu_torch.mesh import RankMesh
    n, d, n_micro, b = 8, LLAMA3_8B["dm"], 8, 512
    g = torch.Generator(device="cuda").manual_seed(47)
    x = torch.randn(n_micro, b, d, generator=g, device="cuda")
    w = torch.randn(n, d, d, generator=g, device="cuda") * 1.5 / d ** 0.5
    with pinned(EXAMPLE_TUNE):
        mesh = RankMesh({"pp": n})
        mesh.teams("pp")
    fn = pp.make_pipeline(mesh, n_micro)
    zero(counters)
    got, p50 = example_p50(lambda: fn(x, w))
    launches = launched(counters)
    err = check_close("pipeline", got, pp.reference_pipeline(x, w))
    mesh.destroy()
    log(f"pipeline: {n} stages of {d}, {n_micro} microbatches of {b} "
        f"tokens, f32: max abs diff {err:.3e} from reference_pipeline | "
        f"p50 {p50:.3f} ms over {EXAMPLE_RUNS} runs | launches {launches} "
        f"| card {smi}")
    return {"p50_ms": p50, "launches": launches}


def moe_run(smi, counters) -> dict:
    """Mixtral 8x7B's experts (8 of 4096 -> 14336, one a rank), 1024
    tokens a rank, capacity 1024 / 8 (factor 1.0: tokens beyond it are
    dropped), against reference_moe."""
    import torch
    from ucc_tpu_torch.examples import moe_ep
    from ucc_tpu_torch.mesh import RankMesh
    n, d, hid = (MIXTRAL_EXPERTS[k] for k in ("n", "dm", "hidden"))
    per = 1024
    cap = per // n                  # capacity factor 1.0
    g = torch.Generator(device="cuda").manual_seed(48)
    x = torch.randn(n * per, d, generator=g, device="cuda")
    w_up = torch.randn(n, d, hid, generator=g, device="cuda") / d ** 0.5
    w_dn = torch.randn(n, hid, d, generator=g, device="cuda") / hid ** 0.5
    assign = torch.randint(0, n, (n * per,), generator=g, device="cuda",
                           dtype=torch.int32)
    with pinned(EXAMPLE_TUNE):
        mesh = RankMesh({"ep": n})
        mesh.teams("ep")
    fn = moe_ep.make_moe_layer(mesh, d, cap)
    zero(counters)
    got, p50 = example_p50(lambda: fn(x, w_up, w_dn, assign))
    launches = launched(counters)
    want = moe_ep.reference_moe(x, w_up, w_dn, assign, cap)
    dropped = int((want.abs().sum(1) == 0).sum())
    err = check_close("MoE", got, want)
    mesh.destroy()
    log(f"MoE: Mixtral 8x7B experts ({n} of {d} -> {hid}, one a rank), "
        f"{per} tokens a rank, capacity {cap}, f32: max abs diff {err:.3e} "
        f"from reference_moe ({dropped} tokens dropped) | p50 {p50:.3f} ms "
        f"over {EXAMPLE_RUNS} runs | launches {launches} | card {smi}")
    return {"p50_ms": p50, "launches": launches}


def sp_attention_runs(smi, counters) -> dict:
    """The ring and Ulysses attentions at 32 heads of 128 over 8192 tokens
    on 8 sp ranks, f32, against reference_attention."""
    import torch
    from ucc_tpu_torch.examples import ring_attention as ra
    from ucc_tpu_torch.mesh import RankMesh
    h, d = LLAMA3_8B["heads"], LLAMA3_8B["e"]
    g = torch.Generator(device="cuda").manual_seed(49)
    q, k, v = (torch.randn(h, CONTEXT, d, generator=g, device="cuda")
               for _ in range(3))
    want = ra.reference_attention(q, k, v)
    out = {}
    with pinned(EXAMPLE_TUNE):
        mesh = RankMesh({"sp": N_RANKS})
        mesh.teams("sp")
    for kind, make in (("ring", ra.make_ring_attention),
                       ("ulysses", ra.make_ulysses_attention)):
        fn = make(mesh)
        zero(counters)
        got, p50 = example_p50(lambda: fn(q, k, v))
        launches = launched(counters)
        err = check_close(f"{kind} attention", got, want)
        log(f"{kind} attention: {h} heads of {d}, {CONTEXT} tokens over "
            f"{N_RANKS} sp ranks, f32: max abs diff {err:.3e} from "
            f"reference_attention | p50 {p50:.3f} ms over {EXAMPLE_RUNS} "
            f"runs | launches {launches} | card {smi}")
        out[kind] = {"p50_ms": p50, "launches": launches}
        del got
    mesh.destroy()
    return out


def main_path_training(smi, counters) -> dict:
    """The in-graph API's paths: the GQA step at full width (default and
    pinned gradient AVG), then the MHA step, DP x TP, the pipeline, MoE,
    and the ring and Ulysses attentions once each."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    out = {"gqa": gqa_training(smi, counters)}
    for name, fn in (("mha", mha_training), ("dp_tp", dp_tp_training),
                     ("pipeline", pipeline_run), ("moe", moe_run)):
        out[name] = fn(smi, counters)
        torch.cuda.empty_cache()
    out.update(sp_attention_runs(smi, counters))
    log(f"training phase: {time.perf_counter() - t0:.1f} s")
    return out


# -- 6. core: triggered collectives, sub-teams, runtime fallback, coll
#    plugins, metrics and profiling --------------------------------------

#: the phase's pin: every ring_cuda collective (the sub-teams run all five)
RING_TUNE = "allreduce,reduce_scatter,allgather,bcast,alltoall:@ring_cuda:inf"
#: a sub-team's runs: (collective, f32 elements in and out per rank of a
#: 4-rank team, root, seed): phase 3's shapes, the allgather's 2 Mi shard
#: gathered 4 ways
SUB_RUNS = (
    ("ALLREDUCE", MAIN_COUNT, MAIN_COUNT, 0, 61),
    ("REDUCE_SCATTER", MAIN_COUNT, MAIN_COUNT // 4, 0, 62),
    ("ALLGATHER", AG_MAIN_COUNT, AG_MAIN_COUNT * 4, 0, 63),
    ("BCAST", MAIN_COUNT, MAIN_COUNT, 1, 64),
    ("ALLTOALL", MAIN_COUNT, MAIN_COUNT, 0, 65),
)
#: the coll plugin's module, registered in sys.modules at run time
PLUGIN = "chip_smoke_coll_plugin"
#: profiled rounds in the profiling child
PROFILED_ROUNDS = 4


def until(ctxs, cond, what, timeout=60.0) -> None:
    """Progress every context until cond() holds."""
    deadline = time.monotonic() + timeout
    while not cond():
        for c in ctxs:
            c.progress()
        if time.monotonic() > deadline:
            raise RuntimeError(f"{what} did not complete in {timeout} s")


def settled(reqs) -> bool:
    """Every request ran to an end (polled, each of them, every pass)."""
    import ucc_tpu_torch as ucc
    sts = [rq.test() for rq in reqs]
    return all(s not in (ucc.Status.IN_PROGRESS,
                         ucc.Status.OPERATION_INITIALIZED) for s in sts)


def all_ok(reqs, what) -> None:
    import ucc_tpu_torch as ucc
    bad = [s for s in (rq.test() for rq in reqs) if s != ucc.Status.OK]
    if bad:
        raise AssertionError(f"{what} failed: {bad[0]}")


def allreduce_reqs(teams, srcs, dsts, persistent=True, cb=None):
    """An allreduce SUM request per rank, src -> dst, with the user
    callback *cb*."""
    import ucc_tpu_torch as ucc
    f32 = ucc.DataType.FLOAT32
    flags = ucc.CollArgsFlags.PERSISTENT if persistent else \
        ucc.CollArgsFlags(0)
    return [t.collective_init(ucc.CollArgs(
        coll_type=ucc.CollType.ALLREDUCE, op=ucc.ReductionOp.SUM,
        src=ucc.BufferInfo(s, s.numel(), f32),
        dst=ucc.BufferInfo(d, d.numel(), f32), flags=flags, cb=cb))
        for t, s, d in zip(teams, srcs, dsts)]


def out_types(ees):
    """Each EE's out events' types, popped until it has none."""
    return [[ev.ev_type for ev in iter(ee.get_event, None)] for ee in ees]


def one_round(ctxs, reqs, what) -> None:
    for rq in reqs:
        rq.post()
    until(ctxs, lambda: settled(reqs), what)
    all_ok(reqs, what)


def check_events(what, ees, rounds=1) -> None:
    want = [["collective_post", "collective_complete"] * rounds] * len(ees)
    got = out_types(ees)
    if got != want:
        raise AssertionError(f"{what}: event_out {got}, want {want[0]} on "
                             f"every rank")


def split(parents, ranks):
    """Team.create_from_parent on every parent rank; the members' teams in
    the new team's rank order (non-members must get None)."""
    import ucc_tpu_torch as ucc
    subs = [ucc.Team.create_from_parent(t, ranks) for t in parents]
    if [i for i, t in enumerate(subs) if t is not None] != sorted(ranks):
        raise AssertionError(f"create_from_parent({ranks}) gave teams to "
                             f"{[t is not None for t in subs]}")
    return [subs[r] for r in ranks]


def create(ctxs, teams, what) -> None:
    import ucc_tpu_torch as ucc
    until(ctxs, lambda: all([t.create_test() != ucc.Status.IN_PROGRESS
                             for t in teams]), what)
    bad = [s for s in (t.create_test() for t in teams) if s != ucc.Status.OK]
    if bad:
        raise AssertionError(f"{what}: team create failed: {bad[0]}")


def core_triggered(smi, ctxs, pinned, default, counters, kernels) -> dict:
    """EE-triggered allreduces of 16 Mi f32 on the 8 ranks: pinned to
    ring_cuda and by the default selection, each src made on a side stream
    behind a sleep; the fast-lane regression; a CPU_THREAD EE; the p50 of
    triggered rounds beside plain persistent rounds. Returns the runs'
    launches."""
    import torch
    import ucc_tpu_torch as ucc
    from ucc_tpu_torch.tl import torch_ops
    n = N_RANKS
    sum_ = ucc.ReductionOp.SUM
    total = {}

    def add(got):
        for k, v in got.items():
            total[k] = total.get(k, 0) + v

    g = torch.Generator(device="cuda").manual_seed(51)
    srcs = [torch.randn(MAIN_COUNT, generator=g, device="cuda")
            for _ in range(n)]
    dsts = [torch.empty_like(s) for s in srcs]
    ring_ref = kernels["ring_allreduce_chunked"][1]

    def plain(alg):
        if alg == "xla":
            return [torch_ops.allreduce_ops(srcs, sum_)] * n
        return ring_ref(srcs, sum_, 0)

    # data readiness: the producers still run when the checks are made
    for teams, alg, want in ((pinned, "ring_cuda",
                              {"ring_allreduce_chunked": 1}),
                             (default, "xla", {})):
        reqs = allreduce_reqs(teams, srcs, dsts)
        got_alg = {rq.task.alg_name for rq in reqs}
        if got_alg != {alg}:
            raise AssertionError(f"triggered allreduce selected {got_alg}")
        ees = [ucc.Ee(t, ucc.EeType.CUDA_STREAM) for t in teams]
        side = torch.cuda.Stream()
        torch.cuda.synchronize()
        zero(counters)
        with torch.cuda.stream(side):
            torch.cuda._sleep(SLEEP_CYCLES)
            for s in srcs:
                s.mul_(2)
            events = [ucc.UccEvent(payload=s) for s in srcs]
        for ee, ev, rq in zip(ees, events, reqs):
            ee.triggered_post(ev, rq)
        for _ in range(64):
            for c in ctxs:
                c.progress()
        early = launched(counters)
        held = {rq.test().name for rq in reqs}
        if side.query():
            raise AssertionError("the producers finished before the checks "
                                 "were made: raise SLEEP_CYCLES")
        if early or held != {"OPERATION_INITIALIZED"}:
            raise AssertionError(f"triggered {alg}: before its producers "
                                 f"finished, launches {early}, requests "
                                 f"{held}")
        until(ctxs, lambda: settled(reqs), f"triggered {alg}")
        all_ok(reqs, f"triggered {alg}")
        torch.cuda.synchronize()
        got = launched(counters)
        if got != want:
            raise AssertionError(f"triggered {alg}: launches {got}, want "
                                 f"{want}")
        add(got)
        err = compare(f"triggered {alg} allreduce of 2 x src", dsts,
                      plain(alg))
        check_events(f"triggered {alg}", ees)
        for ee in ees:
            ee.destroy()
        for rq in reqs:
            rq.finalize()
        log(f"core: triggered allreduce (CUDA_STREAM, src made on a side "
            f"stream behind a {SLEEP_CYCLES}-cycle sleep) via {alg}: "
            f"requests {held.pop()} and launches {early or 0} while the "
            f"producers ran, then {got or 'no kernel'}; dst bitwise the "
            f"plain version (max abs err {err}); event_out post + "
            f"complete on every rank")

    # the fast-lane regression: two plain rounds arm the lane, then a
    # triggered round must still deliver its completion event, and the
    # next plain round takes the lane again
    reqs = allreduce_reqs(pinned, srcs, dsts)
    zero(counters)
    for _ in range(2):
        one_round(ctxs, reqs, "plain round")
    if not reqs[0]._fast:
        raise AssertionError("two plain rounds did not arm the fast lane")
    ees = [ucc.Ee(t, ucc.EeType.CUDA_STREAM) for t in pinned]
    for ee, s, rq in zip(ees, srcs, reqs):
        ee.triggered_post(ucc.UccEvent(payload=s), rq)
    until(ctxs, lambda: settled(reqs), "triggered round after the lane")
    all_ok(reqs, "triggered round after the lane")
    check_events("triggered round after the lane", ees)
    if any(rq.task.cb is not None for rq in reqs):
        raise AssertionError("the EE left its callback on the task")
    one_round(ctxs, reqs, "plain round after the trigger")
    torch.cuda.synchronize()
    got = launched(counters)
    if got != {"ring_allreduce_chunked": 4}:
        raise AssertionError(f"fast-lane regression: launches {got}")
    add(got)
    compare("fast-lane regression", dsts, plain("ring_cuda"))
    for ee in ees:
        ee.destroy()
    for rq in reqs:
        rq.finalize()
    log("core: fast-lane regression: 2 plain rounds (lane armed), a "
        "triggered round (post + complete on every rank), a plain round "
        "on the lane again; 4 launches, bitwise")

    # a CPU_THREAD EE: its thread progresses the context; the host sets
    # the events
    reqs = allreduce_reqs(pinned, srcs, dsts, persistent=False)
    ees = [ucc.Ee(t, ucc.EeType.CPU_THREAD) for t in pinned]
    zero(counters)
    evs = [ucc.UccEvent() for _ in ees]
    for ee, ev, rq in zip(ees, evs, reqs):
        ee.triggered_post(ev, rq)
    time.sleep(0.05)
    held = {rq.test().name for rq in reqs}
    if held != {"OPERATION_INITIALIZED"} or launched(counters):
        raise AssertionError(f"CPU_THREAD EE posted before its events: "
                             f"{held}, {launched(counters)}")
    for ee, ev in zip(ees, evs):
        ee.set_event(ev)
    deadline = time.monotonic() + 60
    while not settled(reqs):
        time.sleep(0.0005)
        if time.monotonic() > deadline:
            raise RuntimeError("CPU_THREAD EE allreduce did not complete")
    all_ok(reqs, "CPU_THREAD EE allreduce")
    torch.cuda.synchronize()
    got = launched(counters)
    if got != {"ring_allreduce_chunked": 1}:
        raise AssertionError(f"CPU_THREAD EE: launches {got}")
    add(got)
    compare("CPU_THREAD EE allreduce", dsts, plain("ring_cuda"))
    check_events("CPU_THREAD EE", ees)
    for ee in ees:
        ee.destroy()
    log("core: CPU_THREAD EE (ThreadMode.MULTIPLE contexts): held until "
        "the host set the events, then 1 launch from the EE threads, "
        "bitwise")

    # triggered rounds against plain persistent rounds, on the fast lane
    # and, with a user callback (an observer), on the generic path, in
    # one call
    reqs = allreduce_reqs(pinned, srcs, dsts)
    zero(counters)
    plain_samples = time_rounds(ctxs, reqs, "plain persistent allreduce")
    reqs = allreduce_reqs(pinned, srcs, dsts, cb=lambda task, st: None)
    generic_samples = time_rounds(ctxs, reqs, "generic persistent allreduce")
    reqs = allreduce_reqs(pinned, srcs, dsts)
    ees = [ucc.Ee(t, ucc.EeType.CUDA_STREAM) for t in pinned]
    trig_samples = []
    for i in range(WARMUP + ITERS):
        t0 = time.perf_counter()
        for ee, s, rq in zip(ees, srcs, reqs):
            ee.triggered_post(ucc.UccEvent(payload=s), rq)
        until(ctxs, lambda: settled(reqs), "triggered round")
        if i >= WARMUP:
            trig_samples.append(time.perf_counter() - t0)
        all_ok(reqs, "triggered round")
        check_events("timed triggered round", ees)
    torch.cuda.synchronize()
    got = launched(counters)
    if got != {"ring_allreduce_chunked": 3 * (WARMUP + ITERS)}:
        raise AssertionError(f"timed rounds: launches {got}")
    add(got)
    compare("timed triggered rounds", dsts, plain("ring_cuda"))
    for ee in ees:
        ee.destroy()
    for rq in reqs:
        rq.finalize()
    log(f"core: allreduce 16 Mi f32 x 8 via ring_cuda, persistent: plain "
        f"(fast lane) {p50_line(plain_samples)} | plain with a callback "
        f"(generic path) {p50_line(generic_samples)} | triggered "
        f"(CUDA_STREAM, ready src) {p50_line(trig_samples)} | card {smi}")
    del srcs, dsts
    torch.cuda.empty_cache()
    return {"launches": total, "plain_p50_ms": median_ms(plain_samples),
            "generic_p50_ms": median_ms(generic_samples),
            "triggered_p50_ms": median_ms(trig_samples)}


def core_sub_teams(smi, ctxs, pinned, counters, kernels) -> dict:
    """create_from_parent: [0..3] and [4..7] of the pinned 8-rank team,
    then [0, 2] of the first; each 4-rank team runs SUB_RUNS pinned to
    ring_cuda (25 rounds, bitwise the plain version), the first's kernels
    timed alone at n = 4; a 4-rank team by the default selection; the
    2-rank team's allreduce. Returns the runs' launches and the n = 4
    kernel records."""
    import torch
    import ucc_tpu_torch as ucc
    from ucc_tpu_torch.tl import torch_ops
    sum_ = ucc.ReductionOp.SUM
    rounds = WARMUP + ITERS
    total, timed = {}, {}
    os.environ["UCC_TL_RING_CUDA_TUNE"] = RING_TUNE
    lo, hi = split(pinned, [0, 1, 2, 3]), split(pinned, [4, 5, 6, 7])
    create(ctxs, lo + hi, "4-rank sub-teams")
    pair = split(lo, [0, 2])
    create(ctxs, pair, "2-rank sub-team of a sub-team")
    os.environ.pop("UCC_TL_RING_CUDA_TUNE")
    low = split(pinned, [0, 1, 2, 3])        # read without the TUNE
    create(ctxs, low, "4-rank sub-team, default selection")
    for what, teams in (("[0..3]", lo), ("[4..7]", hi), ("[0, 2]", pair),
                        ("[0..3] by the default", low)):
        check_ids(teams, f"sub-team {what}")
    if [t.size for t in lo + hi + pair] != [4] * 8 + [2] * 2 or \
            [t.rank for t in lo] != [0, 1, 2, 3]:
        raise AssertionError("sub-team sizes or ranks are wrong")

    def run(teams, coll, count, dst_count, root, seed, alg, what):
        zero(counters)
        samples, srcs, dsts, got_alg = run_main_path(
            ctxs, teams, coll, count, dst_count, root, seed)
        got = launched(counters)
        if got_alg != alg:
            raise AssertionError(f"{what} selected {got_alg}, not {alg}")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        return samples, srcs, dsts, got

    for name, teams in (("[0, 1, 2, 3]", lo), ("[4, 5, 6, 7]", hi)):
        for coll, count, dst_count, root, seed in SUB_RUNS:
            what = f"sub-team {name} {coll}"
            samples, srcs, dsts, got = run(teams, coll, count, dst_count,
                                           root, seed, "ring_cuda", what)
            if len(got) != 1 or list(got.values()) != [rounds]:
                raise AssertionError(f"{what}: launches {got}, want one "
                                     f"kernel {rounds} times")
            kname = next(iter(got))
            wrapper, ref = kernels[kname]
            plain = ref(srcs, sum_, root)
            check_main_result(coll, srcs, dsts, plain, root)
            line = (f"core: {what} {count} f32/rank in, {dst_count} out via "
                    f"ring_cuda: {p50_line(samples)} | {kname} launches "
                    f"{got[kname]}, bitwise")
            if teams is lo:
                bufs = dsts if coll == "BCAST" else None
                del dsts, plain
                max_err, ms, plain_ms, library_ms = measure(
                    coll, wrapper, ref, srcs, dst_count, root, bufs)
                flops = 3 * count if coll in ("ALLREDUCE",
                                              "REDUCE_SCATTER") else 0
                bound, bound_by = bound_ms(
                    least_bytes(coll, 4, count, dst_count), flops)
                timed[kname] = {"n": 4, "ms": ms, "bound_ms": bound,
                                "bound_by": bound_by, "share": bound / ms,
                                "plain_ms": plain_ms,
                                "library_ms": library_ms,
                                "max_abs_err": max_err}
                line += (f" | {kname} n=4 {ms:.4f} ms, bound {bound:.4f} "
                         f"ms ({bound_by}), roofline share "
                         f"{bound / ms:.4f} | plain {plain_ms:.3f} ms | "
                         f"{CONVENTIONS[coll][1]} {library_ms:.4f} ms")
                del bufs
            log(f"{line} | card {smi}")
            del srcs
            torch.cuda.empty_cache()

    samples, srcs, dsts, got = run(low, "ALLREDUCE", MAIN_COUNT, MAIN_COUNT,
                                   0, 66, "xla", "default 4-rank allreduce")
    if got:
        raise AssertionError(f"default 4-rank allreduce launched {got}")
    check_main_result("ALLREDUCE", srcs, dsts,
                      [torch_ops.allreduce_ops(srcs, sum_)] * 4, 0)
    log(f"core: sub-team [0, 1, 2, 3] ALLREDUCE 16 Mi by the default "
        f"(torch_ops/xla): {p50_line(samples)} | no kernel | card {smi}")
    samples, srcs, dsts, got = run(pair, "ALLREDUCE", MAIN_COUNT,
                                   MAIN_COUNT, 0, 67, "ring_cuda",
                                   "2-rank allreduce")
    if len(got) != 1 or list(got.values()) != [rounds]:
        raise AssertionError(f"2-rank allreduce: launches {got}")
    kname = next(iter(got))
    check_main_result("ALLREDUCE", srcs, dsts,
                      kernels[kname][1](srcs, sum_, 0), 0)
    log(f"core: sub-team [0, 2] of [0, 1, 2, 3] ALLREDUCE 16 Mi via "
        f"ring_cuda: {p50_line(samples)} | {kname} launches {got[kname]}, "
        f"bitwise | card {smi}")
    del srcs, dsts
    for t in lo + hi + pair + low:
        t.destroy()
    torch.cuda.empty_cache()
    return {"launches": total, "n4": timed}


#: rounds of the runtime fallback, and of its next candidate alone
FALLBACK_ROUNDS = 5


def core_fallback(smi, ctxs, pinned, default, counters) -> dict:
    """FALLBACK_ROUNDS non-persistent allreduces of 16 Mi f32 whose first
    candidate (ring_cuda, pinned) fails at post before committing data:
    each must end OK on the next candidate, bitwise that candidate's
    result alone, with coll_fallback_runtime 1 per rank; then as many
    rounds of the candidate alone. Returns both medians, in host ms."""
    import tempfile
    import torch
    import ucc_tpu_torch as ucc
    from ucc_tpu_torch.obs import metrics
    n = N_RANKS
    g = torch.Generator(device="cuda").manual_seed(68)
    srcs = [torch.randn(MAIN_COUNT, generator=g, device="cuda")
            for _ in range(n)]
    dsts = [torch.empty_like(s) for s in srcs]
    alone = [torch.empty_like(s) for s in srcs]

    def timed(reqs, what):
        t0 = time.perf_counter()
        one_round(ctxs, reqs, what)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    fb_s, alone_s = [], []
    with tempfile.TemporaryDirectory() as tmp:
        metrics.enable(file=os.path.join(tmp, "stats.json"))
        try:
            for _ in range(FALLBACK_ROUNDS):
                reqs = allreduce_reqs(pinned, srcs, dsts, persistent=False)
                if {rq.task.alg_name for rq in reqs} != {"ring_cuda"} or \
                        not all(rq._fallback for rq in reqs):
                    raise AssertionError("the fallback run's first candidate "
                                         "is not ring_cuda with a chain "
                                         "behind it")
                for rq in reqs:
                    rq.task.post_fn = lambda: ucc.Status.ERR_NO_RESOURCE
                    rq.task.data_committed = False
                metrics.reset()
                zero(counters)
                fb_s.append(timed(reqs, "allreduce with a failing first "
                                        "candidate"))
                got = launched(counters)
                fb = metrics.snapshot()["counters"].get(
                    "coll_fallback_runtime")
                algs = {rq.task.alg_name for rq in reqs}
                if algs != {"xla"} or got or \
                        not all(rq._fb_used for rq in reqs):
                    raise AssertionError(f"runtime fallback ran {algs}, "
                                         f"launches {got}")
                if fb != {"core|allreduce|xla": n}:
                    raise AssertionError(f"coll_fallback_runtime {fb}, want "
                                         f"{n} (1 per rank)")
                plain = allreduce_reqs(default, srcs, alone,
                                       persistent=False)
                if {rq.task.alg_name for rq in plain} != {"xla"}:
                    raise AssertionError("the default is not xla")
                alone_s.append(timed(plain, "the next candidate alone"))
                compare("runtime fallback vs its candidate alone", dsts,
                        alone)
        finally:
            metrics.disable()
            metrics.reset()
    out = {"fallback_ms": median_ms(fb_s), "alone_ms": median_ms(alone_s)}
    log(f"core: runtime fallback, {FALLBACK_ROUNDS} rounds: ring_cuda "
        f"failed at post (ERR_NO_RESOURCE, nothing committed) -> xla on "
        f"every rank, bitwise xla alone, coll_fallback_runtime 1 per rank "
        f"each round; host ms per round, median (each round): "
        f"{out['fallback_ms']:.3f} "
        f"({', '.join(f'{t * 1e3:.3f}' for t in fb_s)}) with the fallback, "
        f"{out['alone_ms']:.3f} "
        f"({', '.join(f'{t * 1e3:.3f}' for t in alone_s)}) alone | card "
        f"{smi}")
    del srcs, dsts, alone
    torch.cuda.empty_cache()
    return out


def core_plugin(smi, ctxs, counters, kernels) -> dict:
    """A coll plugin made at run time (a module in sys.modules) adds an
    allreduce AlgSpec to tl/ring_cuda that delegates to the ring task;
    UCC_TL_RING_CUDA_COLL_PLUGINS and TUNE select it."""
    import types
    import ucc_tpu_torch as ucc
    from ucc_tpu_torch.tl.base import AlgSpec
    from ucc_tpu_torch.tl.ring_cuda import RingCudaCollTask
    plugin = types.ModuleType(PLUGIN)
    plugin.registrations = plugin.inits = 0

    def ucc_coll_plugin(tl_team):
        plugin.registrations += 1

        def init(ia, team):
            plugin.inits += 1
            return RingCudaCollTask(ia, team)
        return {ucc.CollType.ALLREDUCE: [AlgSpec(100, "plugin_ring", init)]}

    plugin.ucc_coll_plugin = ucc_coll_plugin
    sys.modules[PLUGIN] = plugin
    os.environ["UCC_TL_RING_CUDA_COLL_PLUGINS"] = PLUGIN
    os.environ["UCC_TL_RING_CUDA_TUNE"] = "allreduce:@plugin_ring:inf"
    try:
        teams = make_team(ctxs)
    finally:
        os.environ.pop("UCC_TL_RING_CUDA_COLL_PLUGINS")
        os.environ.pop("UCC_TL_RING_CUDA_TUNE")
        sys.modules.pop(PLUGIN)
    zero(counters)
    samples, srcs, dsts, alg = run_main_path(
        ctxs, teams, "ALLREDUCE", MAIN_COUNT, MAIN_COUNT, 0, 69)
    got = launched(counters)
    rounds = WARMUP + ITERS
    if alg != "plugin_ring" or got != {"ring_allreduce_chunked": rounds} \
            or plugin.inits != N_RANKS or plugin.registrations != N_RANKS:
        raise AssertionError(f"coll plugin: alg {alg}, launches {got}, "
                             f"{plugin.registrations} registrations, "
                             f"{plugin.inits} inits")
    check_main_result("ALLREDUCE", srcs, dsts,
                      kernels["ring_allreduce_chunked"][1](
                          srcs, ucc.ReductionOp.SUM, 0), 0)
    for t in teams:
        t.destroy()
    log(f"core: coll plugin 'plugin_ring' on tl/ring_cuda (registered by "
        f"{plugin.registrations} TL teams, {plugin.inits} inits): "
        f"{p50_line(samples)} | ring_allreduce_chunked launches "
        f"{got['ring_allreduce_chunked']}, bitwise | card {smi}")
    return {"launches": got}


def core_gen_backend(smi, counters) -> None:
    """UCC_GEN_DEVICE_BACKEND=xla: gen_dev_ring_c2 at 16 Mi through the
    stack as torch ops (no kernel), bitwise the fold route's kernel on the
    same srcs."""
    import torch
    import ucc_tpu_torch as ucc
    from ucc_tpu_torch.dsl import lower_device as ld
    from ucc_tpu_torch.kernels import gen_device as kgd
    os.environ["UCC_TL_TORCH_OPS_TUNE"] = "allreduce:@gen_dev_ring_c2:inf"
    try:
        ctxs, teams = make_job(N_RANKS, GEN_DEVICE="y",
                               GEN_DEVICE_BACKEND="xla")
    finally:
        os.environ.pop("UCC_TL_TORCH_OPS_TUNE")
    zero(counters)
    samples, srcs, dsts, alg = run_main_path(
        ctxs, teams, "ALLREDUCE", MAIN_COUNT, MAIN_COUNT, 0, 70)
    got = launched(counters)
    if alg != "gen_dev_ring_c2" or got:
        raise AssertionError(f"backend xla: alg {alg}, launches {got}")
    prog = {ld.dev_alg_name(p): p for p in
            ld.device_programs(N_RANKS, "int8")}["gen_dev_ring_c2"]
    plan = ld.device_plan(prog, N_RANKS, MAIN_COUNT)
    fold = [torch.empty_like(s) for s in srcs]
    kgd.gen_device_ring(srcs, fold, ucc.ReductionOp.SUM, plan=plan).done()
    torch.cuda.synchronize()
    compare("gen_dev_ring_c2 backend xla vs the fold route", dsts, fold)
    for t in teams:
        t.destroy()
    for c in ctxs:
        c.destroy()
    log(f"core: gen_dev_ring_c2 allreduce 16 Mi with "
        f"UCC_GEN_DEVICE_BACKEND=xla (torch ops, no launch): "
        f"{p50_line(samples)} | bitwise the fold kernel on the same srcs "
        f"| card {smi}")
    del srcs, dsts, fold
    torch.cuda.empty_cache()


def core_child(mode: str) -> int:
    """The metrics or profiling run, in a process of its own so that
    UCC_STATS / UCC_PROFILE_MODE are read at import: 8 ranks pinned to
    ring_cuda, 16 Mi f32. ``stats``: the main allreduce's persistent rounds;
    prints the counters. ``profile``: PROFILED_ROUNDS non-persistent
    rounds. Its last line is one JSON object."""
    import torch
    import ucc_tpu_torch as ucc
    from ucc_tpu_torch.obs import metrics
    os.environ["UCC_TL_RING_CUDA_TUNE"] = RING_TUNE
    ctxs, teams = make_job(N_RANKS)
    g = torch.Generator(device="cuda").manual_seed(71)
    srcs = [torch.randn(MAIN_COUNT, generator=g, device="cuda")
            for _ in range(N_RANKS)]
    dsts = [torch.empty_like(s) for s in srcs]
    out = {"mode": mode}
    if mode == "stats":
        reqs = allreduce_reqs(teams, srcs, dsts)
        time_rounds(ctxs, reqs, "stats child allreduce")
        out["counters"] = metrics.snapshot()["counters"]
        out["fast"] = bool(reqs[0]._fast)
    else:
        seqs = []
        for _ in range(PROFILED_ROUNDS):
            reqs = allreduce_reqs(teams, srcs, dsts, persistent=False)
            seqs.append([rq.task.seq_num for rq in reqs])
            one_round(ctxs, reqs, "profiled allreduce")
            for rq in reqs:
                rq.finalize()
        out["seqs"] = seqs
    for t in teams:
        t.destroy()
    for c in ctxs:
        c.destroy()
    torch.cuda.synchronize()
    print(json.dumps(out), flush=True)
    return 0


def run_child(mode: str, env: dict) -> dict:
    """chip_smoke.py --core-child <mode> under *env*; its last line."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--core-child", mode],
        env={**os.environ, **env}, capture_output=True, text=True,
        timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"the {mode} child failed ({res.returncode}): "
                           f"{res.stderr[-4000:]}")
    out = json.loads(res.stdout.strip().splitlines()[-1])
    out["seconds"] = time.perf_counter() - t0
    return out


def core_metrics_profiling(smi) -> None:
    """UCC_STATS=y: the main allreduce's rounds count coll_posted every
    round and coll_fast_repost every round from the second (the probe
    arms the lane on the second post). UCC_PROFILE_MODE=log: each profiled
    request writes one coll_allreduce B/E pair, and its task's span, with
    the request's id, inside it."""
    import tempfile
    rounds = WARMUP + ITERS
    with tempfile.TemporaryDirectory() as tmp:
        stats = run_child("stats", {
            "UCC_STATS": "y",
            "UCC_STATS_FILE": os.path.join(tmp, "stats.json")})
        trace = os.path.join(tmp, "trace.json")
        prof = run_child("profile", {"UCC_PROFILE_MODE": "log",
                                     "UCC_PROFILE_FILE": trace})
        with open(trace) as fh:
            recs = [json.loads(line) for line in fh]
    key = "core|allreduce|ring_cuda"
    c = stats["counters"]
    want = {"coll_posted": N_RANKS * rounds,
            "coll_fast_repost": N_RANKS * (rounds - 1)}
    got = {k: c.get(k, {}).get(key) for k in want}
    if got != want or not stats["fast"]:
        raise AssertionError(f"UCC_STATS counters {c}, want {want} under "
                             f"{key}")
    pairs = 0
    for seq in (s for rnd in prof["seqs"] for s in rnd):
        seen = [(r["name"], r["ph"]) for r in recs if r.get("span") == seq]
        if seen != [("coll_allreduce", "B"), ("task_RingCudaCollTask", "B"),
                    ("task_RingCudaCollTask", "E"), ("coll_allreduce", "E")]:
            raise AssertionError(f"profile of request {seq}: {seen}")
        pairs += 1
    log(f"core: UCC_STATS=y ({stats['seconds']:.1f} s child): "
        f"{rounds} persistent rounds x {N_RANKS} ranks -> coll_posted "
        f"{got['coll_posted']}, coll_fast_repost {got['coll_fast_repost']} "
        f"(every round from the second) | UCC_PROFILE_MODE=log "
        f"({prof['seconds']:.1f} s child): {pairs} coll_allreduce B/E "
        f"pairs ({PROFILED_ROUNDS} rounds x {N_RANKS} ranks), each around "
        f"its task's span of the same id | card {smi}")


def main_path_core(smi, counters) -> dict:
    """Phase 6: the core's foundations on the card. Returns every kernel's
    launches over the phase's runs, the triggered and plain p50s and the
    n = 4 kernel times."""
    import torch
    import ucc_tpu_torch as ucc
    t0 = time.perf_counter()
    kernels = wrappers()
    os.environ["UCC_TL_RING_CUDA_TUNE"] = RING_TUNE
    try:
        ctxs, pinned = make_job(
            N_RANKS, ucc.LibParams(thread_mode=ucc.ThreadMode.MULTIPLE))
    finally:
        os.environ.pop("UCC_TL_RING_CUDA_TUNE")
    default = make_team(ctxs)
    out = {"launches": {}}

    def add(got):
        for k, v in got.items():
            out["launches"][k] = out["launches"].get(k, 0) + v

    trig = core_triggered(smi, ctxs, pinned, default, counters, kernels)
    add(trig.pop("launches"))
    out.update(trig)
    sub = core_sub_teams(smi, ctxs, pinned, counters, kernels)
    add(sub["launches"])
    out["n4"] = sub["n4"]
    out.update(core_fallback(smi, ctxs, pinned, default, counters))
    add(core_plugin(smi, ctxs, counters, kernels)["launches"])
    for t in pinned + default:
        t.destroy()
    for c in ctxs:
        c.destroy()
    torch.cuda.empty_cache()
    core_gen_backend(smi, counters)
    core_metrics_profiling(smi)
    log(f"core phase: {time.perf_counter() - t0:.1f} s")
    return out


#: phase 7: every collective type tl/shm serves by the default selection,
#: on HOST memory (collective, root, variant)
HOST_RUNS = (
    ("ALLREDUCE", 0, ""), ("REDUCE_SCATTER", 0, ""), ("ALLGATHER", 0, ""),
    ("ALLGATHERV", 0, ""), ("BCAST", 3, ""), ("REDUCE", 3, ""),
    ("GATHER", 3, ""), ("SCATTER", 3, ""), ("ALLTOALL", 0, ""),
    ("ALLTOALLV", 0, "numpy"), ("BARRIER", 0, ""), ("FANIN", 3, ""),
    ("FANOUT", 3, ""), ("ALLREDUCE", 0, "int32"),
)
#: rounds of a host run: one to warm the pool's leases, then the timed
HOST_WARMUP = 1


def host_cpu() -> str:
    """The host CPU: lscpu's model name, or where the machine reports none
    ("unknown" in a virtual machine), its vendor, family, model and MHz
    from /proc/cpuinfo; and the CPU count."""
    info = {}
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                key, _, val = line.partition(":")
                if not key.strip():
                    break                       # the first CPU only
                info.setdefault(key.strip(), val.strip())
    except OSError:
        pass
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        out = ""
    for line in out.splitlines():
        key, _, val = line.partition(":")
        if key.strip() == "Model name":
            info["model name"] = val.strip()
    model = info.get("model name", "")
    if model in ("", "unknown"):
        model = (f"{info.get('vendor_id', 'unknown vendor')} family "
                 f"{info.get('cpu family', '?')} model "
                 f"{info.get('model', '?')} (model name not reported), "
                 f"{info.get('cpu MHz', '?')} MHz")
    return f"{model}, {os.cpu_count()} CPUs"


def host_case(coll, root, variant, n, count, seed):
    """(every rank's persistent CollArgs, the result buffers, every rank's
    expected result (None: not compared)) of one host run: CPU tensors
    (numpy arrays for variant "numpy") of integer-valued f32 (int32 for
    variant "int32"), so any summation order is exact. `count` is the
    per-rank f32 count of allreduce, reduce, bcast, reduce_scatter's src
    and alltoall; allgather, gather and scatter move count / n a rank."""
    import numpy as np
    import torch
    import ucc_tpu_torch as ucc
    g = torch.Generator().manual_seed(seed)
    itype = variant == "int32"
    dt = ucc.DataType.INT32 if itype else ucc.DataType.FLOAT32
    tdt = torch.int32 if itype else torch.float32
    P = ucc.CollArgsFlags.PERSISTENT
    CT = ucc.CollType[coll]
    SUM = ucc.ReductionOp.SUM
    B = count // n

    def ints(c):
        return torch.randint(-64, 64, (c,), generator=g).to(tdt)

    def bi(t):
        return ucc.BufferInfo(t, t.numel() if hasattr(t, "numel")
                              else t.size, dt)

    def biv(t, counts):
        return ucc.BufferInfoV(t, counts, None, dt)

    if coll in ("BARRIER", "FANIN", "FANOUT"):
        return [ucc.CollArgs(coll_type=CT, root=root, flags=P)
                for _ in range(n)], [], []
    if coll in ("ALLREDUCE", "REDUCE"):
        srcs = [ints(count) for _ in range(n)]
        dsts = [torch.zeros(count, dtype=tdt)
                if coll == "ALLREDUCE" or r == root else None
                for r in range(n)]
        total = torch.stack(srcs).sum(0, dtype=tdt)
        return [ucc.CollArgs(coll_type=CT, op=SUM, root=root,
                             src=bi(srcs[r]),
                             dst=None if dsts[r] is None else bi(dsts[r]),
                             flags=P) for r in range(n)], dsts, \
            [total if d is not None else None for d in dsts]
    if coll == "BCAST":
        bufs = [ints(count) if r == root else torch.zeros(count, dtype=tdt)
                for r in range(n)]
        want = bufs[root].clone()
        return [ucc.CollArgs(coll_type=CT, root=root, src=bi(bufs[r]),
                             flags=P) for r in range(n)], bufs, [want] * n
    if coll == "REDUCE_SCATTER":
        srcs = [ints(count) for _ in range(n)]
        dsts = [torch.zeros(B, dtype=tdt) for _ in range(n)]
        total = torch.stack(srcs).sum(0, dtype=tdt)
        return [ucc.CollArgs(coll_type=CT, op=SUM, src=bi(srcs[r]),
                             dst=bi(dsts[r]), flags=P) for r in range(n)], \
            dsts, [total[r * B:(r + 1) * B] for r in range(n)]
    if coll in ("ALLGATHER", "ALLGATHERV", "GATHER"):
        counts = uneven(count, n) if coll.endswith("V") else [B] * n
        srcs = [ints(c) for c in counts]
        receives = [coll != "GATHER" or r == root for r in range(n)]
        dsts = [torch.zeros(count, dtype=tdt) if rc else None
                for rc in receives]
        return [ucc.CollArgs(
            coll_type=CT, root=root, src=bi(srcs[r]),
            dst=(biv(dsts[r], counts) if coll.endswith("V") else
                 None if dsts[r] is None else bi(dsts[r])), flags=P)
            for r in range(n)], dsts, \
            [torch.cat(srcs) if rc else None for rc in receives]
    if coll == "SCATTER":
        src = ints(count)
        dsts = [torch.zeros(B, dtype=tdt) for _ in range(n)]
        return [ucc.CollArgs(coll_type=CT, root=root,
                             src=bi(src) if r == root else None,
                             dst=bi(dsts[r]), flags=P)
                for r in range(n)], dsts, \
            [src[r * B:(r + 1) * B] for r in range(n)]
    # ALLTOALL, ALLTOALLV (numpy arrays: the one case of numpy buffers)
    if coll == "ALLTOALLV":
        ramp = [c - B for c in uneven(count, n)]
        m = [[B + ramp[(i + j) % n] for j in range(n)] for i in range(n)]
    else:
        m = [[B] * n for _ in range(n)]
    srcs = [ints(count) for _ in range(n)]
    sd = [displs_of(m[i]) for i in range(n)]
    want = [torch.cat([srcs[i][sd[i][p]:sd[i][p] + m[i][p]]
                       for i in range(n)]) for p in range(n)]
    if variant == "numpy":
        srcs = [s.numpy() for s in srcs]
        dsts = [np.zeros(int(w.numel()), np.float32) for w in want]
        return [ucc.CollArgs(
            coll_type=CT, src=biv(srcs[r], m[r]),
            dst=biv(dsts[r], [m[i][r] for i in range(n)]), flags=P)
            for r in range(n)], dsts, want
    dsts = [torch.zeros(count, dtype=tdt) for _ in range(n)]
    return [ucc.CollArgs(coll_type=CT, src=bi(srcs[r]), dst=bi(dsts[r]),
                         flags=P) for r in range(n)], dsts, want


def host_rounds(ctxs, reqs, what):
    """HOST_WARMUP + ITERS rounds of persistent host requests; the ITERS
    rounds' seconds. Finalizes the requests."""
    def one_round():
        for rq in reqs:
            rq.post()
        until(ctxs, lambda: settled(reqs), what)
        all_ok(reqs, what)

    for _ in range(HOST_WARMUP):
        one_round()
    samples = []
    for _ in range(ITERS):
        t0 = time.perf_counter()
        one_round()
        samples.append(time.perf_counter() - t0)
    for rq in reqs:
        rq.finalize()
    return samples


def host_run(ctxs, teams, coll, root, variant, count, seed, what):
    """One host run: init, the rounds, every result bitwise its expected
    one. Returns (alg, samples, dsts as tensors)."""
    import torch
    argses, dsts, want = host_case(coll, root, variant, len(teams), count,
                                   seed)
    reqs = [t.collective_init(a) for t, a in zip(teams, argses)]
    algs = {rq.task.alg_name for rq in reqs}
    if len(algs) != 1:
        raise AssertionError(f"{what}: ranks selected {algs}")
    samples = host_rounds(ctxs, reqs, what)
    got = [None if d is None else
           (torch.from_numpy(d) if not isinstance(d, torch.Tensor) else d)
           for d in dsts]
    for r, (d, w) in enumerate(zip(got, want)):
        if w is not None and not bits_equal(d, w):
            raise AssertionError(f"{what} rank {r}: not bitwise its "
                                 "expected result")
    return algs.pop(), samples, got


def check_ids(teams, what) -> int:
    """Every member of a team holds one id; returns it."""
    ids = {t.id for t in teams}
    if len(ids) != 1 or None in ids:
        raise AssertionError(f"{what}: members hold ids {sorted(ids)}")
    return ids.pop()


def host_create_ms(ctxs, reps=9) -> float:
    """Median ms to create an 8-rank team over *ctxs* (then destroyed)."""
    import ucc_tpu_torch as ucc
    samples = []
    for _ in range(reps):
        tw = ucc.ThreadOobWorld(len(ctxs))
        t0 = time.perf_counter()
        teams = [c.create_team_post(ucc.TeamParams(oob=tw.endpoint(r)))
                 for r, c in enumerate(ctxs)]
        create(ctxs, teams, "timed team create")
        samples.append(time.perf_counter() - t0)
        if teams[0].service_team is not None:
            check_ids(teams, "timed team create")
        for t in teams:
            t.destroy()
    return median_ms(samples)


def main_path_host(smi, counters, kernels) -> dict:
    """Phase 7: the host transports in one process. Returns every kernel's
    launches over the phase's runs."""
    import torch
    import ucc_tpu_torch as ucc
    from ucc_tpu_torch import native
    t0 = time.perf_counter()
    cpu = host_cpu()
    here = os.path.dirname(os.path.abspath(__file__))
    pkg = os.path.join(here, "ucc_tpu_torch")
    lib = native.get_lib()
    if lib is None or os.path.dirname(native._SRC_PATH) != \
            os.path.join(pkg, "native_src") or \
            not native.lib_path.startswith(os.path.join(pkg, "build") +
                                           os.sep):
        raise AssertionError(f"native core not built from ucc_tpu_torch/"
                             f"native_src: {native.lib_path}, "
                             f"{native.build_error()}")
    log(f"host: native core {native.lib_path} (ABI "
        f"{int(lib.ucc_abi_version())}), built in {native.build_seconds:.1f}"
        f" s by this process (0.0: it was on disk) | host CPU {cpu}")
    total = {}

    def add(got):
        for k, v in got.items():
            total[k] = total.get(k, 0) + v

    os.environ["UCC_TL_RING_CUDA_TUNE"] = RING_TUNE
    try:
        ctxs, teams = make_job(N_RANKS)
    finally:
        os.environ.pop("UCC_TL_RING_CUDA_TUNE")
    eps = [c.tl_contexts["shm"].obj.transport for c in ctxs]
    if any(ep.native is None for ep in eps):
        raise AssertionError("a tl/shm endpoint matches in Python, not "
                             "natively")
    sends = sum(ep.n_direct + ep.n_eager + ep.n_rndv for ep in eps)

    # -- every collective type tl/shm serves, 64 Ki and 16 Mi a rank ------
    p50s, kept = {}, {}
    zero(counters)
    for count in (SMALL_COUNT, MAIN_COUNT):
        for i, (coll, root, variant) in enumerate(HOST_RUNS):
            if count == SMALL_COUNT and coll in ("BARRIER", "FANIN",
                                                 "FANOUT"):
                continue
            what = f"host {coll}{' ' + variant if variant else ''}"
            alg, samples, dsts = host_run(ctxs, teams, coll, root, variant,
                                          count, 70 + i, what)
            p50s[(coll, variant, count)] = samples
            if count == MAIN_COUNT and coll in ("ALLREDUCE", "ALLTOALL") \
                    and not variant:
                # the native matcher's results, for the Python matcher's
                kept[coll] = (70 + i, dsts)
            del dsts
            size = "no data" if coll in ("BARRIER", "FANIN", "FANOUT") \
                else f"{count} {'int32' if variant == 'int32' else 'f32'}" \
                     f"/rank{' (numpy arrays)' if variant == 'numpy' else ''}"
            rooted = f" from root {root}" if coll in (
                "BCAST", "REDUCE", "GATHER", "SCATTER", "FANIN",
                "FANOUT") else ""
            log(f"host: {coll}{rooted} {size} via shm/{alg}: "
                f"{p50_line(samples)}, bitwise | host CPU {cpu} | card "
                f"{smi}")
    if launched(counters):
        raise AssertionError(f"host collectives launched {launched(counters)}")
    sent = sum(ep.n_direct + ep.n_eager + ep.n_rndv for ep in eps) - sends
    log(f"host: sends {sent} (direct "
        f"{sum(ep.n_direct for ep in eps)}, eager "
        f"{sum(ep.n_eager for ep in eps)}, rndv "
        f"{sum(ep.n_rndv for ep in eps)}), every endpoint native")

    # -- the Python matcher, bitwise the native one ------------------------
    os.environ["UCC_TL_SHM_NATIVE"] = "n"
    try:
        py_ctxs, py_teams = make_job(N_RANKS)
    finally:
        os.environ.pop("UCC_TL_SHM_NATIVE")
    if any(c.tl_contexts["shm"].obj.transport.native is not None
           for c in py_ctxs):
        raise AssertionError("UCC_TL_SHM_NATIVE=n left a native endpoint")
    for coll, (seed, nat) in kept.items():
        what = f"host {coll} 16 Mi"
        alg, samples, py = host_run(py_ctxs, py_teams, coll, 0, "",
                                    MAIN_COUNT, seed, f"{what} python")
        if not all(bits_equal(a, b) for a, b in zip(nat, py)):
            raise AssertionError(f"{what}: the Python matcher's result is "
                                 "not bitwise the native one")
        log(f"host: {coll} {MAIN_COUNT} f32/rank via shm/{alg} on the "
            f"Python matcher (UCC_TL_SHM_NATIVE=n): {p50_line(samples)}, "
            f"bitwise the native matcher's (native: "
            f"{p50_line(p50s[(coll, '', MAIN_COUNT)])}) | host CPU {cpu} | "
            f"card {smi}")
        del nat, py
    kept.clear()
    for t in py_teams:
        t.destroy()
    for c in py_ctxs:
        c.destroy()

    # -- one team, two memory types: the HOST allreduce above, then a CUDA
    # one on the same team --------------------------------------------------
    host_samples = p50s[("ALLREDUCE", "", MAIN_COUNT)]
    zero(counters)
    samples, srcs, dsts, alg = run_main_path(ctxs, teams, "ALLREDUCE",
                                             MAIN_COUNT, MAIN_COUNT, 0, 91)
    got = launched(counters)
    add(got)
    want = WARMUP + ITERS
    if alg != "ring_cuda" or got != {"ring_allreduce_chunked": want}:
        raise AssertionError(f"CUDA allreduce beside host ones: {alg}, "
                             f"launches {got}")
    check_main_result("ALLREDUCE", srcs, dsts, kernels[
        "ring_allreduce_chunked"][1](srcs, ucc.ReductionOp.SUM, 0), 0)
    log(f"host: one team, two memory types: HOST allreduce 16 Mi via shm "
        f"({p50_line(host_samples)}), then CUDA allreduce 16 Mi via "
        f"{alg}: {p50_line(samples)} | ring_allreduce_chunked launches "
        f"{got['ring_allreduce_chunked']}, bitwise | card {smi}")
    del srcs, dsts
    zero(counters)
    plain_samples, srcs, dsts, alg = run_main_path(
        ctxs, teams, "BCAST", MAIN_COUNT, MAIN_COUNT, 3, 92)
    add(launched(counters))
    del srcs, dsts
    torch.cuda.empty_cache()

    # -- team ids: the teams of phase 7 and two sub-teams -------------------
    ids = [check_ids(teams, "the phase's 8-rank team")]
    lo, hi = split(teams, [0, 1, 2, 3]), split(teams, [4, 5, 6, 7])
    create(ctxs, lo + hi, "host sub-teams")
    ids += [check_ids(lo, "sub-team [0..3]"), check_ids(hi, "sub-team [4..7]")]
    for t in lo + hi:
        t.destroy()
    shm_ms = host_create_ms(ctxs)
    for t in teams:
        t.destroy()
    for c in ctxs:
        c.destroy()

    # -- the datatype check --------------------------------------------------
    os.environ["UCC_TL_RING_CUDA_TUNE"] = RING_TUNE
    try:
        chk_ctxs, chk = make_job(N_RANKS, CHECK_ASYMMETRIC_DT="y")
    finally:
        os.environ.pop("UCC_TL_RING_CUDA_TUNE")
    ids.append(check_ids(chk, "the dt-checked team"))
    zero(counters)
    samples, srcs, dsts, alg = run_main_path(chk_ctxs, chk, "BCAST",
                                             MAIN_COUNT, MAIN_COUNT, 3, 92)
    got = launched(counters)
    add(got)
    if alg != "ring_cuda" or got != {"ring_bcast_chunked": want}:
        raise AssertionError(f"dt-checked bcast: {alg}, launches {got}")
    check_main_result("BCAST", srcs, dsts, kernels["ring_bcast_chunked"][1](
        srcs, None, 3), 3)
    log(f"host: UCC_CHECK_ASYMMETRIC_DT=y, CUDA bcast 16 Mi from root 3 via "
        f"{alg}: {p50_line(samples)} | without the check "
        f"{p50_line(plain_samples)} | ring_bcast_chunked launches "
        f"{got['ring_bcast_chunked']}, bitwise | card {smi}")
    del srcs, dsts
    bufs = [torch.zeros(MAIN_COUNT, device="cuda",
                        dtype=torch.int32 if r == 5 else torch.float32)
            for r in range(N_RANKS)]
    reqs = [t.collective_init(ucc.CollArgs(
        coll_type=ucc.CollType.BCAST, root=3, src=ucc.BufferInfo(
            b, MAIN_COUNT, ucc.DataType.INT32 if r == 5
            else ucc.DataType.FLOAT32, mem_type=ucc.MemoryType.CUDA)))
        for r, (t, b) in enumerate(zip(chk, bufs))]
    zero(counters)
    for rq in reqs:
        rq.post()
    until(chk_ctxs, lambda: settled(reqs), "asymmetric bcast")
    sts = [rq.test() for rq in reqs]
    if any(s != ucc.Status.ERR_INVALID_PARAM for s in sts) or \
            launched(counters):
        raise AssertionError(f"asymmetric bcast: {sts}, launches "
                             f"{launched(counters)}")
    for rq in reqs:
        rq.finalize()
    log(f"host: asymmetric bcast (rank 5 INT32, the others FLOAT32): "
        f"ERR_INVALID_PARAM on all {N_RANKS} ranks, no launch")
    del bufs
    for t in chk:
        t.destroy()
    for c in chk_ctxs:
        c.destroy()
    torch.cuda.empty_cache()

    # -- team create with and without a tl/shm service team ---------------
    bare, bare_teams = make_job(N_RANKS, TLS="ring_cuda,torch_ops,self")
    if bare_teams[0].service_team is not None:
        raise AssertionError("a team without tl/shm has a service team")
    for t in bare_teams:
        t.destroy()
    bare_ms = host_create_ms(bare)
    for c in bare:
        c.destroy()
    log(f"host: team ids agreed: {ids} (the phase's team, sub-teams "
        f"[0..3] and [4..7], the dt-checked team) | 8-rank team create "
        f"median {shm_ms:.3f} ms with its tl/shm service team, "
        f"{bare_ms:.3f} ms without tl/shm | host CPU {cpu} | card {smi}")
    log(f"host phase: {time.perf_counter() - t0:.1f} s")
    return {"launches": total}


# ---------------------------------------------------------------------------
# phase 8: host teams across processes
# ---------------------------------------------------------------------------

#: phase 8's workers, one rank each
PROCS_N = 4
#: f32 a rank of phase 8's host runs: both below the arena's largest
#: message (8 MiB)
PROCS_COUNTS = (64 << 10, 1 << 20)
PROCS_RUNS = (
    ("ALLREDUCE", 0, ""), ("REDUCE_SCATTER", 0, ""), ("ALLGATHER", 0, ""),
    ("BCAST", 3, ""), ("REDUCE", 3, ""), ("ALLTOALL", 0, ""),
    ("ALLTOALLV", 0, "numpy"), ("BARRIER", 0, ""), ("ALLREDUCE", 0, "int32"),
)
#: the one-sided algorithms, pinned by TUNE, at this count a rank
ONESIDED_RUNS = (("ALLTOALL", "alltoall:@onesided"),
                 ("ALLTOALLV", "alltoallv:@onesided"),
                 ("ALLREDUCE", "allreduce:@sliding_window"))
ONESIDED_COUNT = 64 << 10
#: the team over a TcpTreeOob: ranks per node and radix
TREE_PPN, TREE_RADIX = 2, 2
#: where the workers put their arenas
ARENA_GLOB = "ucc-torch-ipc-"


def procs_onesided(ucc, team, team_oob, rank, n, coll, memh, seed):
    """One one-sided run on this rank: (status, algorithm, bitwise)."""
    import numpy as np
    import torch
    argses, dsts, want = host_case(coll, 0, "numpy" if coll == "ALLTOALLV"
                                   else "", n, ONESIDED_COUNT, seed)
    args = argses[rank]
    args.flags = ucc.CollArgsFlags(0)
    ctx = team.context
    handles = []
    if memh:
        # the handles travel through the team's OOB (the TCP store)
        sides = ("src", "dst") if coll == "ALLREDUCE" else ("dst",)
        for side in sides:
            h = ctx.mem_map(getattr(args, side).buffer)
            handles.append(h)
            req = team_oob.allgather(h)
            setattr(args, f"{side}_memh", list(req.wait()))
            args.flags |= (ucc.CollArgsFlags.MEM_MAP_SRC_MEMH if side == "src"
                           else ucc.CollArgsFlags.MEM_MAP_DST_MEMH)
        if coll == "ALLTOALLV":
            # the one-sided alltoallv's dst displacements name where this
            # rank's block lands in each peer's dst
            m = [a.src.counts for a in argses]
            args.dst.displacements = [sum(m[q][p] for q in range(rank))
                                      for p in range(n)]
    req = team.collective_init(args)
    req.post()
    st = req.wait(timeout=60)
    alg = req.task.alg_name
    req.finalize()
    for h in handles:
        ctx.mem_unmap(h)
    ok = None
    if st == ucc.Status.OK:
        d = dsts[rank]
        d = torch.from_numpy(d) if not isinstance(d, torch.Tensor) else d
        ok = bits_equal(d, want[rank])
    return st.name, alg, ok


def procs_child(spec_json: str) -> int:
    """One rank of a phase-8 job, in a process of its own: a context over
    a TcpStoreOob, a team over another; the host runs (20 persistent
    rounds each, every result bitwise its expected one), the one-sided
    runs pinned through the spec's TUNE variable, with handles exchanged
    through the team's store and without; optionally a CUDA allreduce
    across the processes (tl/torch_ops, bitwise the integer sum) and a
    team over a TcpTreeOob. Its last line is one JSON object."""
    import torch
    spec = json.loads(spec_json)
    os.environ.update(spec["env"])
    import ucc_tpu_torch as ucc
    from ucc_tpu_torch.tools.perftest import transport_tier
    rank, n, ports = spec["rank"], spec["n"], spec["ports"]
    t0 = time.perf_counter()
    ctx_oob = ucc.TcpStoreOob(rank, n, port=ports[0])
    ctx = ucc.Context(ucc.init(), ucc.ContextParams(oob=ctx_oob))
    team_oob = ucc.TcpStoreOob(rank, n, port=ports[1])

    def new_team(tune=None, oob=team_oob):
        var = spec["tune_var"]
        if tune:
            os.environ[var] = tune
        try:
            return ctx.create_team(ucc.TeamParams(oob=oob))
        finally:
            os.environ.pop(var, None)

    team = new_team()
    out = {"rank": rank, "pid": os.getpid(), "tier": transport_tier(team),
           "svc": team.service_team.TL_CLS.NAME, "ids": [team.id],
           "setup_s": time.perf_counter() - t0, "runs": [], "onesided": []}
    for count in PROCS_COUNTS:
        for i, (coll, root, variant) in enumerate(PROCS_RUNS):
            if coll == "BARRIER" and count != PROCS_COUNTS[0]:
                continue
            argses, dsts, want = host_case(coll, root, variant, n, count,
                                           80 + i)
            req = team.collective_init(argses[rank])
            alg = req.task.alg_name
            samples = host_rounds([ctx], [req], f"procs {coll}")
            ok = True
            if want and want[rank] is not None:
                d = dsts[rank]
                d = torch.from_numpy(d) if not isinstance(d, torch.Tensor) \
                    else d
                ok = bits_equal(d, want[rank])
            out["runs"].append({"coll": coll, "root": root,
                                "variant": variant, "count": count,
                                "alg": alg, "ok": ok,
                                "p50": sorted(samples)[len(samples) // 2]})
            del argses, dsts, want
    for i, (coll, tune) in enumerate(ONESIDED_RUNS):
        for memh in (True, False):
            t = new_team(tune)
            out["ids"].append(t.id)
            st, alg, ok = procs_onesided(ucc, t, team_oob, rank, n, coll,
                                         memh, 90 + i)
            out["onesided"].append({"coll": coll, "memh": memh,
                                    "status": st, "alg": alg, "ok": ok})
            t.destroy()
    if spec.get("cuda"):
        # a device team across the processes: tl/torch_ops by the default
        # selection, each process computing its rank's sum over the four
        # srcs, three of them mapped through CUDA IPC
        kernels = wrappers()
        x = torch.full((MAIN_COUNT,), rank + 1.0, device="cuda")
        y = torch.empty_like(x)
        f32 = ucc.DataType.FLOAT32
        req = team.collective_init(ucc.CollArgs(
            coll_type=ucc.CollType.ALLREDUCE, op=ucc.ReductionOp.SUM,
            src=ucc.BufferInfo(x, MAIN_COUNT, f32,
                               mem_type=ucc.MemoryType.CUDA),
            dst=ucc.BufferInfo(y, MAIN_COUNT, f32,
                               mem_type=ucc.MemoryType.CUDA)))
        req.post()
        out["cuda"] = req.wait(timeout=120).name
        out["cuda_alg"] = req.task.alg_name
        req.finalize()
        torch.cuda.synchronize()
        out["cuda_ok"] = bits_equal(y, torch.full_like(y, n * (n + 1) / 2))
        out["cuda_launches"] = sum(w.launches for w, _ in kernels.values())
        del x, y
    if spec.get("tree"):
        tree = ucc.TcpTreeOob(rank, n, base_port=spec["tree"],
                              ppn=TREE_PPN, radix=TREE_RADIX, key="tree")
        t = ctx.create_team(ucc.TeamParams(oob=tree))
        argses, dsts, want = host_case("ALLREDUCE", 0, "", n,
                                       PROCS_COUNTS[0], 99)
        req = t.collective_init(argses[rank])
        samples = host_rounds([ctx], [req], "tree team allreduce")
        out["tree"] = {"levels": tree.stats["levels"],
                       "max_fanin": tree.stats["max_fanin"],
                       "ok": bits_equal(dsts[rank], want[rank]),
                       "id": t.id,
                       "p50": sorted(samples)[len(samples) // 2]}
        t.destroy()
        tree.close()
    team.destroy()
    ctx.destroy()
    team_oob.close()
    ctx_oob.close()
    out["jax"] = sys.modules.get("jax") is not None
    print(json.dumps(out), flush=True)
    return 0


def procs_job(env, cuda=False, tree=False, timeout=240):
    """PROCS_N processes of procs_child (this script with --procs-child),
    joined by TCP stores on held ports; every process's result. No worker
    outlives the call."""
    import ucc_tpu_torch as ucc
    from ucc_tpu_torch.tools.perftest import HeldPorts
    held = HeldPorts(2)
    block = HeldPorts(ucc.TcpTreeOob.ports_needed(
        PROCS_N, TREE_PPN, TREE_RADIX), contiguous=True) if tree else None
    procs = []
    try:
        for r in range(PROCS_N):
            spec = {"rank": r, "n": PROCS_N, "ports": held.ports,
                    "env": env, "cuda": cuda,
                    "tree": block.ports[0] if block else None,
                    "tune_var": "UCC_TL_SOCKET_TUNE"
                    if env.get("UCC_TLS", "").startswith("socket")
                    else "UCC_TL_IPC_TUNE"}
            # one intra-op thread a worker, as perftest --procs (and
            # torchrun) give several processes of one host
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--procs-child",
                 json.dumps(spec)], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
                env={**os.environ, "OMP_NUM_THREADS":
                     os.environ.get("OMP_NUM_THREADS", "1")}))
        outs = []
        deadline = time.monotonic() + timeout
        for p in procs:
            so, se = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            if p.returncode != 0:
                raise RuntimeError(f"phase 8 worker failed "
                                   f"({p.returncode}): {se[-4000:]}")
            outs.append(json.loads(so.strip().splitlines()[-1]))
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        held.release()
        if block is not None:
            block.release()


def check_procs(outs, what, tier, svc):
    """Every worker: its tier and service TL, no JAX, every host run
    bitwise; one team id per team across the workers; the runs' lines."""
    for o in outs:
        if o["jax"]:
            raise AssertionError(f"{what}: worker {o['rank']} loaded JAX")
        if (o["tier"], o["svc"]) != (tier, svc):
            raise AssertionError(f"{what}: worker {o['rank']} on tier "
                                 f"{o['tier']}, service TL {o['svc']}")
        bad = [r for r in o["runs"] if not r["ok"]]
        if bad:
            raise AssertionError(f"{what}: worker {o['rank']}: {bad[0]} not "
                                 "bitwise its expected result")
    ids = {tuple(o["ids"]) for o in outs}
    if len(ids) != 1:
        raise AssertionError(f"{what}: the workers' team ids differ: {ids}")
    if len({o["pid"] for o in outs}) != PROCS_N:
        raise AssertionError(f"{what}: workers share a process")
    return ids.pop()


def log_procs_runs(outs, what, cpu, smi):
    for i, run in enumerate(outs[0]["runs"]):
        algs = {o["runs"][i]["alg"] for o in outs}
        p50 = max(o["runs"][i]["p50"] for o in outs)
        size = "no data" if run["coll"] == "BARRIER" else \
            f"{run['count']} {'int32' if run['variant'] == 'int32' else 'f32'}" \
            f"/rank{' (numpy arrays)' if run['variant'] == 'numpy' else ''}"
        rooted = f" from root {run['root']}" if run["coll"] in (
            "BCAST", "REDUCE") else ""
        log(f"procs: {what} {run['coll']}{rooted} {size} via "
            f"{outs[0]['tier']}/{'/'.join(sorted(algs))}: p50 "
            f"{p50 * 1e3:.3f} ms (the slowest rank's) over {ITERS} rounds, "
            f"bitwise | {PROCS_N} processes | host CPU {cpu} | card {smi}")


def perftest_procs(args, env) -> list:
    """python -m ucc_tpu_torch.tools.perftest --procs PROCS_N *args; its
    JSON records (the command must exit 0)."""
    here = os.path.dirname(os.path.abspath(__file__))
    penv = {**os.environ, **env}
    res = subprocess.run(
        [sys.executable, "-m", "ucc_tpu_torch.tools.perftest", "--procs",
         str(PROCS_N), "-m", "host", "--json", *args], cwd=here, env=penv,
        capture_output=True, text=True, timeout=240)
    if res.returncode != 0:
        raise AssertionError(f"perftest --procs {args} exited "
                             f"{res.returncode}: {res.stderr[-4000:]}")
    return [json.loads(x) for x in res.stdout.splitlines()
            if x.startswith("{")]


def make_store_job(n, ports):
    """n contexts in this process, one a thread, over a TcpStoreOob (its
    server in rank 0's), and a team over a second store."""
    import ucc_tpu_torch as ucc
    oobs = [None] * n
    ctxs = [None] * n
    errs = []

    def make(r):
        try:
            oobs[r] = ucc.TcpStoreOob(r, n, port=ports[0])
            ctxs[r] = ucc.Context(ucc.init(), ucc.ContextParams(oob=oobs[r]))
        except Exception as e:  # noqa: BLE001 - re-raised below
            errs.append(e)

    threads = [threading.Thread(target=make, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    if errs:
        raise errs[0]
    team_oobs = [None] * n
    threads = [threading.Thread(target=lambda r: team_oobs.__setitem__(
        r, ucc.TcpStoreOob(r, n, port=ports[1])), args=(r,))
        for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return ctxs, oobs, team_oobs


def store_teams(ctxs, team_oobs, what):
    import ucc_tpu_torch as ucc
    teams = [c.create_team_post(ucc.TeamParams(oob=o))
             for c, o in zip(ctxs, team_oobs)]
    create(ctxs, teams, what)
    check_ids(teams, what)
    return teams


def main_path_procs(smi, counters, kernels, ring_p50) -> dict:
    """Phase 8: host teams across processes. Returns every kernel's
    launches over the phase's runs."""
    import numpy as np
    import torch
    import ucc_tpu_torch as ucc
    t0 = time.perf_counter()
    cpu = host_cpu()
    before = sorted(f for f in os.listdir("/dev/shm")
                    if f.startswith(ARENA_GLOB))

    # -- the ipc tier, default TLS: host runs, one-sided, CUDA memory ----
    t1 = time.perf_counter()
    outs = procs_job({}, cuda=True)
    ids = check_procs(outs, "ipc", "ipc", "ipc")
    log(f"procs: ipc tier, default TLS, {PROCS_N} processes over "
        f"TcpStoreOob: service team tl/{outs[0]['svc']}, team ids {ids} on "
        f"every worker, setup {max(o['setup_s'] for o in outs):.1f} s, the "
        f"job {time.perf_counter() - t1:.1f} s")
    log_procs_runs(outs, "ipc", cpu, smi)
    for o in outs:
        if (o["cuda"], o["cuda_alg"], o["cuda_ok"], o["cuda_launches"]) != \
                ("OK", "xla", True, 0):
            raise AssertionError(f"CUDA allreduce across processes on worker "
                                 f"{o['rank']}: {o['cuda']} via "
                                 f"{o['cuda_alg']}, bitwise {o['cuda_ok']}, "
                                 f"launches {o['cuda_launches']}")
        for run in o["onesided"]:
            # the arena serves one-sided ops between ranks of one process
            # only, as in the JAX package
            if run["status"] != "ERR_NOT_SUPPORTED":
                raise AssertionError(f"ipc one-sided {run} on worker "
                                     f"{o['rank']}")
    log(f"procs: CUDA allreduce {MAIN_COUNT} f32 on the team across "
        f"processes: OK via torch_ops/xla on all {PROCS_N} workers, bitwise "
        f"the integer sum, no kernel launched, every worker exited 0")
    log(f"procs: ipc one-sided ({', '.join(t for _, t in ONESIDED_RUNS)}; "
        f"handles through the store and the bootstrap path): "
        f"ERR_NOT_SUPPORTED on all {PROCS_N} workers, no hang (the arena "
        f"serves one-sided ops within one process)")

    # -- the socket tier: host runs, one-sided, a team over a tree OOB ---
    t1 = time.perf_counter()
    outs = procs_job({"UCC_TLS": "socket,self"}, tree=True)
    ids = check_procs(outs, "socket", "socket", "socket")
    log(f"procs: socket tier (UCC_TLS=socket,self), {PROCS_N} processes: "
        f"service team tl/{outs[0]['svc']}, team ids {ids}, the job "
        f"{time.perf_counter() - t1:.1f} s")
    log_procs_runs(outs, "socket", cpu, smi)
    for o in outs:
        bad = [r for r in o["onesided"]
               if r["status"] != "OK" or not r["ok"]]
        if bad:
            raise AssertionError(f"socket one-sided on worker {o['rank']}: "
                                 f"{bad[0]}")
        tr = o["tree"]
        if not tr["ok"] or tr["max_fanin"] != TREE_PPN:
            raise AssertionError(f"tree team on worker {o['rank']}: {tr}")
    for run in outs[0]["onesided"]:
        log(f"procs: socket one-sided {run['coll']} {ONESIDED_COUNT} "
            f"f32/rank via {run['alg']} "
            f"({'handles through the store' if run['memh'] else 'bootstrap'}"
            f"): OK, bitwise on all {PROCS_N} workers")
    tr = outs[0]["tree"]
    log(f"procs: a team over TcpTreeOob (ppn {TREE_PPN}, radix "
        f"{TREE_RADIX}): {tr['levels']} levels, fan-in {tr['max_fanin']}, "
        f"id {tr['id']}, allreduce {PROCS_COUNTS[0]} f32/rank bitwise, p50 "
        f"{tr['p50'] * 1e3:.3f} ms")

    # -- one-sided on the ipc tier, within one process -------------------
    os.environ["UCC_TL_IPC_ENABLE"] = "y"
    try:
        ipc_ctxs, first = make_job(PROCS_N, TLS="ipc,self")
    finally:
        os.environ.pop("UCC_TL_IPC_ENABLE")
    for t in first:
        t.destroy()
    for i, (coll, tune) in enumerate(ONESIDED_RUNS):
        os.environ["UCC_TL_IPC_TUNE"] = tune
        try:
            teams = make_team(ipc_ctxs)
        finally:
            os.environ.pop("UCC_TL_IPC_TUNE")
        argses, dsts, want = host_case(coll, 0, "numpy" if coll ==
                                       "ALLTOALLV" else "", PROCS_N,
                                       ONESIDED_COUNT, 90 + i)
        for a in argses:
            a.flags = ucc.CollArgsFlags(0)
        reqs = [t.collective_init(a) for t, a in zip(teams, argses)]
        one_round(ipc_ctxs, reqs, f"ipc one-sided {coll}")
        algs = {rq.task.alg_name for rq in reqs}
        for rq in reqs:
            rq.finalize()
        for d, w in zip(dsts, want):
            d = torch.from_numpy(d) if isinstance(d, np.ndarray) else d
            if not bits_equal(d, w):
                raise AssertionError(f"ipc one-sided {coll}: not bitwise")
        log(f"procs: ipc one-sided {coll} {ONESIDED_COUNT} f32/rank via "
            f"{'/'.join(algs)} ({PROCS_N} ranks of one process on the "
            f"arena, UCC_TL_IPC_ENABLE=y, bootstrap path): bitwise")
        for t in teams:
            t.destroy()
    for c in ipc_ctxs:
        c.destroy()

    # -- in one process over the TCP store: B2 and B9 ---------------------
    from ucc_tpu_torch.tools.perftest import HeldPorts
    t1 = time.perf_counter()
    total = {}
    held = HeldPorts(2)
    try:
        os.environ["UCC_TL_RING_CUDA_TUNE"] = RING_TUNE
        ctxs, oobs, team_oobs = make_store_job(N_RANKS, held.ports)
        teams = store_teams(ctxs, team_oobs, "the TCP-store team")
        os.environ.pop("UCC_TL_RING_CUDA_TUNE")
        for coll, kname, seed in (("ALLREDUCE", "ring_allreduce_chunked", 93),
                                  ("ALLTOALL", "ring_alltoall_chunked", 94)):
            zero(counters)
            samples, srcs, dsts, alg = run_main_path(
                ctxs, teams, coll, MAIN_COUNT, MAIN_COUNT, 0, seed)
            got = launched(counters)
            for k, v in got.items():
                total[k] = total.get(k, 0) + v
            if alg != "ring_cuda" or got != {kname: WARMUP + ITERS}:
                raise AssertionError(f"TCP-store team {coll}: {alg}, "
                                     f"launches {got}")
            check_main_result(coll, srcs, dsts, kernels[kname][1](
                srcs, ucc.ReductionOp.SUM, 0), 0)
            threaded = ring_p50.get((coll, ""))
            log(f"procs: {coll} {MAIN_COUNT} f32/rank on a team over "
                f"TcpStoreOob ({N_RANKS} ranks of this process) via {alg}: "
                f"{p50_line(samples)} | over ThreadOob (phase 3): p50 "
                f"{threaded * 1e3 if threaded else float('nan'):.3f} ms | "
                f"{kname} launches {got[kname]}, bitwise | card {smi}")
            del srcs, dsts
            torch.cuda.empty_cache()
        for t in teams:
            t.destroy()
        samples = []
        for _ in range(9):
            s0 = time.perf_counter()
            ts = store_teams(ctxs, team_oobs, "timed TCP-store team")
            samples.append(time.perf_counter() - s0)
            for t in ts:
                t.destroy()
        store_ms = median_ms(samples)
        thread_ms = host_create_ms(ctxs)
        log(f"procs: {N_RANKS}-rank team create median {store_ms:.3f} ms "
            f"over TcpStoreOob, {thread_ms:.3f} ms over ThreadOob (same "
            f"contexts); the in-process part {time.perf_counter() - t1:.1f}"
            f" s | host CPU {cpu} | card {smi}")
        for c in ctxs:
            c.destroy()
        for o in oobs + team_oobs:
            o.close()
    finally:
        os.environ.pop("UCC_TL_RING_CUDA_TUNE", None)
        held.release()

    # -- perftest --procs ------------------------------------------------
    for args, env, tier in (
            (["-c", "allreduce", "-b", "4K", "-e", "1M"], {}, "ipc"),
            (["-c", "allreduce", "-b", "4K", "-e", "1M"],
             {"UCC_TLS": "socket,self"}, "socket"),
            (["-c", "alltoall", "-O", "-b", "4K", "-e", "64K"],
             {"UCC_TLS": "socket,self"}, "socket")):
        t1 = time.perf_counter()
        recs = perftest_procs(args, env)
        tiers = {r["detail"]["transport"] for r in recs}
        if not recs or tiers != {tier}:
            raise AssertionError(f"perftest --procs {args} {env}: tiers "
                                 f"{tiers}")
        last = recs[-1]
        log(f"procs: perftest --procs {PROCS_N} -m host {' '.join(args)} "
            f"{' '.join(f'{k}={v}' for k, v in env.items())}: exit 0, "
            f"{len(recs)} records, detail.transport {tier}, "
            f"{last['size_bytes']} B p50 {last['p50_us']:.1f} us, "
            f"{time.perf_counter() - t1:.1f} s | host CPU {cpu}")

    # -- hygiene -----------------------------------------------------------
    left = sorted(f for f in os.listdir("/dev/shm")
                  if f.startswith(ARENA_GLOB) and f not in before)
    if left:
        raise AssertionError(f"phase 8 left arenas behind: {left}")
    log(f"procs: no {ARENA_GLOB}* segment left in /dev/shm, every worker "
        f"exited | procs phase: {time.perf_counter() - t0:.1f} s")
    return {"launches": total}


# ---------------------------------------------------------------------------
# phase 2: each kernel's parts (a team across processes launches one each)
# ---------------------------------------------------------------------------

#: (kernel, n, per-rank src count, root) of the part checks: counts that
#: are no multiple of a vector and span several chunks of the chunked
#: entry points, then the main path's runs (MAIN_RUNS), whose counts
#: phase 9 launches by part
PART_CASES = (
    ("ring_allreduce_pass", 8, 65536 + 37, 0),
    ("ring_allreduce_chunked", 8, (1 << 21) + 37, 0),
    ("ring_reduce_scatter_pass", 8, 8 * 8197, 0),
    ("ring_reduce_scatter_chunked", 8, 8 * ((1 << 18) + 5), 0),
    ("ring_allgather_pass", 8, 8197, 0),
    ("ring_allgather_chunked", 8, (1 << 18) + 5, 0),
    ("ring_bcast_pass", 8, 65536 + 37, 3),
    ("ring_bcast_chunked", 8, (1 << 21) + 37, 5),
    ("ring_alltoall_pass", 8, 8 * 8197, 0),
    ("ring_alltoall_chunked", 8, 8 * ((1 << 18) + 5), 0),
) + tuple((kname, N_RANKS, count, root)
          for _c, kname, count, _d, root, _s in MAIN_RUNS)
PARTS = (2, 3, 4)


def part_walks():
    """kernel -> (walk, pieces) of kernels/ring_common.py's parts."""
    from ucc_tpu_torch.kernels import ring_allreduce as kr
    from ucc_tpu_torch.kernels import ring_bcast_a2a as kba
    from ucc_tpu_torch.kernels import ring_rs_ag as krs
    by = {"allreduce": (kr.allreduce_walk, kr.allreduce_pieces),
          "reduce_scatter": (krs.reduce_scatter_walk,
                             krs.reduce_scatter_pieces),
          "allgather": (krs.allgather_walk, krs.allgather_pieces),
          "bcast": (kba.bcast_walk, kba.bcast_pieces),
          "alltoall": (kba.alltoall_walk, kba.alltoall_pieces)}
    return {k: by[k[5:].rsplit("_", 1)[0]] for k in KERNELS}


def phase_kernels_parts() -> None:
    """Every entry point of the five direct sources launched part by part
    (part p of P for P in PARTS, as process p of a team across P
    processes launches it): each part's launch writes exactly its plain
    version's part (every other element keeps its NaN sentinel), and the
    parts' union is bitwise the single launch."""
    import torch
    from ucc_tpu_torch import ReductionOp
    from ucc_tpu_torch.kernels import ring_common as kc
    kernels = wrappers()
    walks = part_walks()
    t0 = time.perf_counter()
    checked = 0
    for name, n, count, root in PART_CASES:
        wrapper, ref = kernels[name]
        walk, pieces = walks[name]
        g = torch.Generator(device="cuda").manual_seed(count)
        srcs = [torch.randn(count, generator=g, device="cuda")
                for _ in range(n)]
        dst_count = n * count if "allgather" in name else (
            count // n if "reduce_scatter" in name else count)
        op = ReductionOp.SUM
        kw = {"root": root}
        plain = ref(srcs, op, root)
        whole = [torch.full((dst_count,), float("nan"), device="cuda")
                 for _ in range(n)]
        wrapper(srcs, whole, op, **kw).wait()
        compare(f"{name} single launch", whole, plain)
        for nparts in PARTS:
            union = [torch.full((dst_count,), float("nan"), device="cuda")
                     for _ in range(n)]
            for p in range(nparts):
                one = [torch.full((dst_count,), float("nan"), device="cuda")
                       for _ in range(n)]
                wrapper(srcs, one, op, part=(p, nparts), **kw).wait()
                want = [torch.full((dst_count,), float("nan"),
                                   device="cuda") for _ in range(n)]
                lo, hi = kc.part_bounds(walk(count, n), (p, nparts), 4)
                if lo < hi:
                    kc.write_part(want, plain, pieces(count, n, lo, hi))
                compare(f"{name} part {p} of {nparts}", one, want)
                wrapper(srcs, union, op, part=(p, nparts), **kw).wait()
                checked += 1
            compare(f"{name} union of {nparts} parts", union, whole)
        del srcs, plain, whole
        torch.cuda.empty_cache()
    log(f"kernels by part: {len(PART_CASES)} cases of the "
        f"{len({c[0] for c in PART_CASES})} entry points x P in {PARTS}: "
        f"{checked} part launches, each bitwise its plain version's part "
        f"(the rest untouched), every union bitwise the single launch, "
        f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 9: device teams across processes
# ---------------------------------------------------------------------------

#: (processes, ranks each) of phase 9's layouts of its 8 ranks
SPAN_LAYOUTS = ((2, 4), (4, 2))
#: phase 9's tl/torch_ops runs: tests/test_xla_multiprocess.py's mode flat
#: at full width (collective, root, f32 elements per rank or block)
SPAN_FLAT = (("ALLREDUCE", 0, MAIN_COUNT), ("GATHER", 1, AG_MAIN_COUNT),
             ("SCATTER", 2, AG_MAIN_COUNT), ("ALLGATHERV", 0, AG_MAIN_COUNT),
             ("BCAST", 3, MAIN_COUNT), ("ALLTOALLV", 0, AG_MAIN_COUNT))
#: where the workers' sync areas and arenas would be left
SPAN_GLOBS = ("ucc-torch-dev-", "ucc-torch-ipc-")


def span_inputs(n, count, seed):
    """The ranks' integer-valued f32 inputs of a run: the same in every
    process, so a worker can rebuild the ranks it does not hold."""
    import torch
    out = []
    for r in range(n):
        g = torch.Generator(device="cuda").manual_seed(seed * 1000 + r)
        out.append(torch.randint(-64, 64, (count,), generator=g,
                                 device="cuda").float())
    return out


def flat_counts(coll, n, c, seed):
    """A v-collective's uneven counts: per rank (allgatherv) or per (src,
    dst) pair (alltoallv), around c."""
    import numpy as np
    rng = np.random.default_rng(seed)
    if coll == "ALLGATHERV":
        return [int(c + x) for x in rng.integers(-c // 4, c // 4, n)]
    return [[int(c + x) for x in rng.integers(-c // 4, c // 4, n)]
            for _ in range(n)]


def flat_args(ucc, coll, root, c, r, n, srcs, seed):
    """Rank r's args of a flat run and its result buffer."""
    import torch
    f32 = ucc.DataType.FLOAT32
    flags = ucc.CollArgsFlags.PERSISTENT
    BI, BV = ucc.BufferInfo, ucc.BufferInfoV
    if coll == "ALLREDUCE":
        dst = torch.empty(c, device="cuda")
        return ucc.CollArgs(coll_type=ucc.CollType.ALLREDUCE,
                            op=ucc.ReductionOp.SUM, src=BI(srcs[r], c, f32),
                            dst=BI(dst, c, f32), flags=flags), dst
    if coll == "GATHER":
        dst = torch.empty(n * c, device="cuda") if r == root else None
        return ucc.CollArgs(coll_type=ucc.CollType.GATHER, root=root,
                            src=BI(srcs[r], c, f32),
                            dst=BI(dst, n * c, f32) if dst is not None
                            else None, flags=flags), dst
    if coll == "SCATTER":
        dst = torch.empty(c, device="cuda")
        return ucc.CollArgs(coll_type=ucc.CollType.SCATTER, root=root,
                            src=BI(srcs[r], n * c, f32) if r == root
                            else None, dst=BI(dst, c, f32),
                            flags=flags), dst
    if coll == "ALLGATHERV":
        counts = flat_counts(coll, n, c, seed)
        dst = torch.empty(sum(counts), device="cuda")
        return ucc.CollArgs(coll_type=ucc.CollType.ALLGATHERV,
                            src=BI(srcs[r][:counts[r]], counts[r], f32),
                            dst=BV(dst, counts, None, f32),
                            flags=flags), dst
    if coll == "BCAST":
        buf = srcs[r].clone() if r == root else torch.zeros(c,
                                                            device="cuda")
        return ucc.CollArgs(coll_type=ucc.CollType.BCAST, root=root,
                            src=BI(buf, c, f32), flags=flags), buf
    m = flat_counts(coll, n, c, seed)
    rc = [m[q][r] for q in range(n)]
    dst = torch.empty(sum(rc), device="cuda")
    return ucc.CollArgs(coll_type=ucc.CollType.ALLTOALLV,
                        src=BV(srcs[r][:sum(m[r])], m[r], None, f32),
                        dst=BV(dst, rc, None, f32), flags=flags), dst


def flat_expected(coll, root, c, r, n, srcs, seed):
    """What an in-process team's tl/torch_ops xla leaves on rank r: the
    same library ops over the same srcs (None where rank r receives
    nothing)."""
    import torch
    from ucc_tpu_torch import ReductionOp
    from ucc_tpu_torch.tl.torch_ops import allreduce_ops, bcast_ops
    if coll == "ALLREDUCE":
        return allreduce_ops(srcs, ReductionOp.SUM)
    if coll == "GATHER":
        return torch.cat(srcs) if r == root else None
    if coll == "SCATTER":
        return srcs[root][r * c:(r + 1) * c]
    if coll == "ALLGATHERV":
        counts = flat_counts(coll, n, c, seed)
        return torch.cat([s[:k] for s, k in zip(srcs, counts)])
    if coll == "BCAST":
        return bcast_ops(srcs, root)
    m = flat_counts(coll, n, c, seed)
    parts = []
    for q in range(n):
        off = sum(m[q][:r])
        parts.append(srcs[q][off:off + m[q][r]])
    return torch.cat(parts)


def make_store_ranks(ranks, n, ports):
    """Contexts of *ranks* (threads of this process) over a TcpStoreOob at
    ports[0]; their OOBs."""
    import ucc_tpu_torch as ucc
    oobs, ctxs, errs = {}, {}, []
    # the libs first, one after another: init loads the components
    libs = {r: ucc.init() for r in ranks}

    def make(r):
        try:
            oobs[r] = ucc.TcpStoreOob(r, n, port=ports[0])
            ctxs[r] = ucc.Context(libs[r], ucc.ContextParams(oob=oobs[r]))
        except Exception as e:  # noqa: BLE001 - re-raised below
            errs.append(e)

    # daemon threads: a worker that fails does not wait on them to exit
    threads = [threading.Thread(target=make, args=(r,), daemon=True)
               for r in ranks]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    if errs:
        raise errs[0]
    return [ctxs[r] for r in ranks], [oobs[r] for r in ranks]


def span_teams(ctxs, ranks, n, port, what):
    """A team of the n ranks over a TcpStoreOob at *port* (the TUNE
    variables are read here); this process's ranks' teams."""
    import ucc_tpu_torch as ucc
    oobs = [ucc.TcpStoreOob(r, n, port=port) for r in ranks]
    teams = [c.create_team_post(ucc.TeamParams(oob=o))
             for c, o in zip(ctxs, oobs)]
    create(ctxs, teams, what)
    return teams, oobs


def span_rounds(ctxs, reqs, kernels, what):
    """One round, then the counters, then time_rounds' WARMUP + ITERS:
    (the timed rounds' seconds, launches per kernel and the span counters
    gained after the first round)."""
    from ucc_tpu_torch.obs import metrics
    one_round(ctxs, reqs, what)
    counts = dict(metrics.span_counts)
    before = {k: w.launches for k, (w, _) in kernels.items()}
    samples = time_rounds(ctxs, reqs, what)
    launches = {k: w.launches - before[k] for k, (w, _) in kernels.items()
                if w.launches != before[k]}
    after = {k: v - counts[k] for k, v in metrics.span_counts.items()}
    return samples, launches, after


def span_child(spec_json: str) -> int:
    """One process of a phase-9 job: its ranks' contexts and two teams
    over TcpStoreOob (tl/ring_cuda pinned for its five collectives, and
    the default selection), the ring and flat runs (WARMUP + ITERS
    persistent rounds after a first one, every local result bitwise what
    an in-process team leaves on the same inputs), and, in process 0,
    every kernel's parts timed in turns on its own copies of the eight
    ranks' buffers. Its last line is one JSON object."""
    import faulthandler
    import torch
    spec = json.loads(spec_json)
    # every thread's stack on stderr before the parent gives up on us
    faulthandler.dump_traceback_later(spec["dump_s"], exit=False)
    import ucc_tpu_torch as ucc
    from ucc_tpu_torch.kernels import ring_common as kc
    ranks, n, ports, me, nprocs = (spec["ranks"], spec["n"], spec["ports"],
                                   spec["proc"], spec["procs"])

    def step(msg):
        print(f"[{time.perf_counter() - t0:.1f} s] {msg}", file=sys.stderr,
              flush=True)

    t0 = time.perf_counter()
    ctxs, oobs = make_store_ranks(ranks, n, ports)
    step("contexts")
    os.environ["UCC_TL_RING_CUDA_TUNE"] = RING_TUNE
    ring, ring_oobs = span_teams(ctxs, ranks, n, ports[1], "ring team")
    os.environ.pop("UCC_TL_RING_CUDA_TUNE")
    step("ring team")
    flat, flat_oobs = span_teams(ctxs, ranks, n, ports[2], "flat team")
    step("flat team")
    out = {"proc": me, "pid": os.getpid(), "ranks": ranks,
           "setup_s": time.perf_counter() - t0, "ring": [], "flat": []}
    kernels = wrappers()
    f32 = ucc.DataType.FLOAT32
    walks = part_walks()
    for coll, kname, count, dst_count, root, seed in MAIN_RUNS:
        srcs = span_inputs(n, count, 90 + seed)
        bufs, argses = [], []
        for r in ranks:
            if coll == "BCAST":
                buf = srcs[r].clone() if r == root else \
                    torch.zeros(count, device="cuda")
                bufs.append(buf)
                argses.append(ucc.CollArgs(
                    coll_type=ucc.CollType.BCAST, root=root,
                    src=ucc.BufferInfo(buf, count, f32),
                    flags=ucc.CollArgsFlags.PERSISTENT))
            else:
                dst = torch.empty(dst_count, device="cuda")
                bufs.append(dst)
                argses.append(ucc.CollArgs(
                    coll_type=ucc.CollType[coll], op=ucc.ReductionOp.SUM,
                    src=ucc.BufferInfo(srcs[r], count, f32),
                    dst=ucc.BufferInfo(dst, dst_count, f32),
                    flags=ucc.CollArgsFlags.PERSISTENT))
        reqs = [t.collective_init(a) for t, a in zip(ring, argses)]
        alg = reqs[0].task.alg_name
        step(f"{coll} {count} via {alg}")
        samples, launches, after = span_rounds(ctxs, reqs, kernels,
                                               f"span {coll}")
        wrapper, _ = kernels[kname]
        # the in-process launch over the same eight srcs
        whole = [torch.empty(dst_count, device="cuda") for _ in range(n)]
        if coll == "BCAST":
            whole = [srcs[root].clone() if r == root else
                     torch.zeros(count, device="cuda") for r in range(n)]
            wrapper(whole, whole, None, root=root).wait()
        else:
            wrapper(srcs, whole, ucc.ReductionOp.SUM, root=root).wait()
        before = wrapper.launches
        ok = all(bits_equal(b, whole[r]) for b, r in zip(bufs, ranks))
        rec = {"coll": coll, "kname": kname, "count": count, "alg": alg,
               "ok": ok, "p50": sorted(samples)[len(samples) // 2],
               "launches": launches, "after_first": after,
               "rounds": WARMUP + ITERS}
        if me == 0:
            # every part alone, then the single launch, in turns, on this
            # process's copies of the eight ranks' buffers
            ins = whole if coll == "BCAST" else srcs
            dsts = whole if coll == "BCAST" else \
                [torch.empty(dst_count, device="cuda") for _ in range(n)]
            table = kc.make_ptr_table(ins, dsts)
            op = None if coll == "BCAST" else ucc.ReductionOp.SUM
            rec["part_ms"] = [cuda_ms(lambda p=p: wrapper(
                ins, dsts, op, root=root, ptr_table=table,
                part=(p, nprocs)), 10) for p in range(nprocs)]
            rec["single_ms"] = cuda_ms(lambda: wrapper(
                ins, dsts, op, root=root, ptr_table=table), 10)
            walk = walks[kname][0](count, n)
            rec["bounds"] = [kc.part_bounds(walk, (p, nprocs), 4)
                             for p in range(nprocs)]
            del ins, dsts, table
        wrapper.launches = before
        out["ring"].append(rec)
        del srcs, bufs, argses, reqs, whole
        torch.cuda.empty_cache()
    for i, (coll, root, c) in enumerate(SPAN_FLAT):
        seed = 300 + i
        # elements a rank's src holds: the root's n blocks of a scatter,
        # the largest uneven count (below 1.25 c) of the v-collectives
        total = {"SCATTER": n * c, "ALLGATHERV": c + c // 4 + 8,
                 "ALLTOALLV": n * (c + c // 4 + 8)}.get(coll, c)
        srcs = span_inputs(n, total, seed)
        pairs = [flat_args(ucc, coll, root, c, r, n, srcs, seed)
                 for r in ranks]
        reqs = [t.collective_init(a) for t, (a, _) in zip(flat, pairs)]
        alg = reqs[0].task.alg_name
        step(f"flat {coll} {c} via {alg}")
        samples, launches, after = span_rounds(ctxs, reqs, kernels,
                                               f"span flat {coll}")
        ok = True
        for r, (_, got) in zip(ranks, pairs):
            want = flat_expected(coll, root, c, r, n, srcs, seed)
            if want is not None and not bits_equal(got, want):
                ok = False
        out["flat"].append({"coll": coll, "root": root, "count": c,
                            "alg": alg, "ok": ok, "launches": launches,
                            "after_first": after,
                            "p50": sorted(samples)[len(samples) // 2]})
        del srcs, pairs, reqs
        torch.cuda.empty_cache()
    for t in ring + flat:
        t.destroy()
    for c in ctxs:
        c.destroy()
    for o in oobs + ring_oobs + flat_oobs:
        o.close()
    faulthandler.cancel_dump_traceback_later()
    step("done")
    out["jax"] = sys.modules.get("jax") is not None
    print(json.dumps(out), flush=True)
    return 0


def span_job(nprocs, per, timeout=240):
    """nprocs processes of span_child (this script with --span-child),
    *per* ranks each, joined by TCP stores on held ports; every process's
    result. Each worker writes into files of its own (a pipe that nobody
    drains would stop a chatty worker, and its peers with it); a worker
    that fails stops the job, and every worker's last output is shown.
    No worker outlives the call."""
    import tempfile
    from ucc_tpu_torch.tools.perftest import HeldPorts
    held = HeldPorts(3)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_span_")
    procs, files = [], []
    try:
        for p in range(nprocs):
            spec = {"ranks": list(range(p * per, (p + 1) * per)),
                    "n": nprocs * per, "ports": held.ports, "proc": p,
                    "procs": nprocs, "dump_s": timeout - 20}
            so = open(os.path.join(tmp, f"{p}.out"), "w+")
            se = open(os.path.join(tmp, f"{p}.err"), "w+")
            files.append((so, se))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--span-child",
                 json.dumps(spec)], stdout=so, stderr=se, text=True,
                env={**os.environ, "OMP_NUM_THREADS":
                     os.environ.get("OMP_NUM_THREADS", "1")}))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                for q in procs:
                    if q.poll() is None:
                        q.kill()
                        q.wait()
                tails = []
                for i, (_, se) in enumerate(files):
                    se.seek(0)
                    tails.append(f"-- worker {i} (rc {procs[i].returncode})"
                                 f":\n{se.read()[-3000:]}")
                what = "phase 9 worker failed" if failed else \
                    f"phase 9 workers did not end in {timeout} s"
                raise RuntimeError("\n".join([what, *tails]))
            time.sleep(0.2)
        outs = []
        for i, (so, se) in enumerate(files):
            so.seek(0)
            lines = so.read().strip().splitlines()
            if procs[i].returncode != 0 or not lines:
                se.seek(0)
                raise RuntimeError(f"phase 9 worker {i} failed "
                                   f"({procs[i].returncode}): "
                                   f"{se.read()[-4000:]}")
            outs.append(json.loads(lines[-1]))
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for so, se in files:
            so.close()
            se.close()
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
        held.release()


def sharing_mode() -> str:
    """How processes share the card: its compute mode (nvidia-smi -q) and
    whether an MPS server runs on this machine."""
    out = subprocess.run(["nvidia-smi", "-q", "-d", "COMPUTE"],
                         capture_output=True, text=True, timeout=60)
    mode = "?"
    for line in out.stdout.splitlines():
        if "Compute Mode" in line:
            mode = line.split(":", 1)[1].strip()
    mps = False
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/comm") as fh:
                mps |= fh.read().strip().startswith("nvidia-cuda-mps")
        except OSError:
            continue
    return f"compute mode {mode}, MPS {'active' if mps else 'not active'}"


def main_path_span(smi, records) -> dict:
    """Phase 9: device teams across processes. Returns every kernel's
    launches over the phase's spanning rounds."""
    t0 = time.perf_counter()
    shm = "/dev/shm"
    before = sorted(f for f in os.listdir(shm)
                    if f.startswith(SPAN_GLOBS))
    log(f"span: how processes share the card: {sharing_mode()} | card {smi}")
    total = {}
    for nprocs, per in SPAN_LAYOUTS:
        t1 = time.perf_counter()
        outs = span_job(nprocs, per)
        lay = f"{nprocs} processes x {per} ranks"
        for o in outs:
            if o["jax"]:
                raise AssertionError(f"span {lay}: worker {o['proc']} "
                                     "loaded JAX")
        if len({o["pid"] for o in outs}) != nprocs:
            raise AssertionError(f"span {lay}: workers share a process")
        for i, rec in enumerate(outs[0]["ring"]):
            runs = [o["ring"][i] for o in outs]
            k = rec["kname"]
            for run in runs:
                if run["alg"] != "ring_cuda" or not run["ok"]:
                    raise AssertionError(f"span {lay} {k}: {run['alg']}, "
                                         f"bitwise {run['ok']}")
                if run["launches"] != {k: run["rounds"]}:
                    raise AssertionError(f"span {lay} {k}: launches "
                                         f"{run['launches']} over "
                                         f"{run['rounds']} rounds, want one "
                                         "a process a round")
                if run["after_first"]["dev_ipc_opens"] or \
                        run["after_first"]["dev_desc_sends"]:
                    raise AssertionError(f"span {lay} {k}: after the first "
                                         f"round {run['after_first']}")
                total[k] = total.get(k, 0) + run["launches"][k]
            p50 = max(run["p50"] for run in runs)
            parts = rec["part_ms"]
            log(f"span: {lay}, {rec['coll']} {rec['count']} f32/rank via "
                f"ring_cuda: p50 {p50 * 1e3:.3f} ms (the slowest "
                f"process's) over {ITERS} persistent rounds, bitwise the "
                f"in-process launch on every rank | {k}: parts "
                f"{' + '.join(f'{m:.4f}' for m in parts)} = "
                f"{sum(parts):.4f} ms (alone, in turns; walk bounds "
                f"{rec['bounds']}), single launch {rec['single_ms']:.4f} ms "
                f"here, {records[k]['ms']:.4f} ms in phase 3 | launches "
                f"{rec['rounds']} a process over {rec['rounds']} rounds | "
                f"after the first round: IPC opens "
                f"{max(r['after_first']['dev_ipc_opens'] for r in runs)}, "
                f"descriptor sends "
                f"{max(r['after_first']['dev_desc_sends'] for r in runs)}"
                f" | card {smi}")
            records[k].setdefault("span", {})[f"{nprocs}x{per}"] = {
                "p50_ms": p50 * 1e3, "part_ms": parts,
                "single_ms": rec["single_ms"]}
        for i, rec in enumerate(outs[0]["flat"]):
            runs = [o["flat"][i] for o in outs]
            for run in runs:
                if run["alg"] != "xla" or not run["ok"] or run["launches"]:
                    raise AssertionError(f"span {lay} flat {run}")
                if run["after_first"]["dev_ipc_opens"] or \
                        run["after_first"]["dev_desc_sends"]:
                    raise AssertionError(f"span {lay} flat {rec['coll']}: "
                                         f"after the first round "
                                         f"{run['after_first']}")
            rooted = f" root {rec['root']}" if rec["coll"] in (
                "GATHER", "SCATTER", "BCAST") else ""
            log(f"span: {lay}, {rec['coll']}{rooted} {rec['count']} "
                f"f32/rank via torch_ops/xla: p50 "
                f"{max(r['p50'] for r in runs) * 1e3:.3f} ms (the slowest "
                f"process's), bitwise the in-process team's ops on every "
                f"rank, no kernel | card {smi}")
        log(f"span: {lay}: setup {max(o['setup_s'] for o in outs):.1f} s, "
            f"the job {time.perf_counter() - t1:.1f} s")
    left = sorted(f for f in os.listdir(shm)
                  if f.startswith(SPAN_GLOBS) and f not in before)
    if left:
        raise AssertionError(f"phase 9 left segments behind: {left}")
    log(f"span: no {'*, '.join(SPAN_GLOBS)}* segment left in /dev/shm, "
        f"every worker exited | span phase: "
        f"{time.perf_counter() - t0:.1f} s")
    return {"launches": total}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    sys.modules.setdefault("jax", None)        # the port must not need JAX
    try:
        import ucc_tpu_torch as ucc
        from ucc_tpu_torch.kernels import build
        from ucc_tpu_torch.kernels import ec_reduce as ker
        from ucc_tpu_torch.kernels import gen_device as kgd
        from ucc_tpu_torch.kernels import ring_allreduce as kr
        from ucc_tpu_torch.kernels import ring_attention as ka
        from ucc_tpu_torch.kernels import ring_bcast_a2a as kba
        from ucc_tpu_torch.kernels import ring_rs_ag as krs
    except ImportError as e:
        print(f"chip_smoke: ucc_tpu_torch not importable here: {e}",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--core-child"]:
        return core_child(sys.argv[2])
    if sys.argv[1:2] == ["--procs-child"]:
        return procs_child(sys.argv[2])
    if sys.argv[1:2] == ["--span-child"]:
        try:
            return span_child(sys.argv[2])
        except BaseException:  # noqa: BLE001 - the job must see it at once
            import traceback
            traceback.print_exc()
            sys.stderr.flush()
            os._exit(1)

    # -- 1. device -------------------------------------------------------
    smi = smi_line()
    t_build = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"CUDA {torch.version.cuda} | python {sys.version.split()[0]}")
    sources = [kr.SOURCE, krs.RS_SOURCE, krs.SOURCE, kba.SOURCE,
               kba.A2A_SOURCE, ker.SOURCE, ka.SOURCE, kgd.SOURCE,
               kgd.FOLD_SOURCE]
    started = {src: ptxas_start(src) for src in sources}
    from ucc_tpu_torch.kernels import cuda_ipc
    build_s = build.build_all(sources + [cuda_ipc.SOURCE])
    log(f"build: {', '.join(sources + [cuda_ipc.SOURCE])} -> "
        f"{build.BUILD_DIR} in {build_s:.1f} s")
    infos = {src: ptxas_read(p) for src, p in started.items()}
    log(f"ptxas and SASS of every source: "
        f"{time.perf_counter() - t_build:.1f} s from the start of the build")
    for src in DIRECT_KERNELS:
        check_direct_sass(src, infos[src])
    check_spills(infos)
    check_wire_and_ec_sass(infos[kgd.SOURCE], infos[ker.SOURCE])
    check_attention_f32_sass(infos[ka.SOURCE])
    ptxas = infos[ka.SOURCE]

    # -- 2. kernels against their plain versions ---------------------------
    phase_kernels()
    phase_kernels_rs_ag()
    phase_kernels_bcast_a2a()
    phase_kernels_parts()
    phase_kernels_wide_types()
    phase_kernels_gen_device()
    phase_kernels_ec()
    torch.backends.cuda.matmul.allow_tf32 = False     # the plain versions
    phase_kernels_attention()

    # -- 3. main path ----------------------------------------------------
    # the ring runs and perftest's allreduce measure tl/ring_cuda, pinned
    # here (tl/torch_ops is the default TL for every collective type)
    os.environ["UCC_TL_RING_CUDA_TUNE"] = \
        "allreduce,reduce_scatter,allgather,bcast,alltoall:@ring_cuda:inf"
    t0 = time.perf_counter()
    ctxs, teams = make_job(N_RANKS)
    log(f"job: {N_RANKS} contexts + team in {time.perf_counter() - t0:.1f} s")
    kernels = wrappers()
    records = {}
    ring_p50 = {}          # the chunked runs' p50, beside the defaults'
    for coll, kname, count, dst_count, root, seed in MAIN_RUNS:
        for wrapper, _ in kernels.values():
            wrapper.launches = 0
        samples, srcs, dsts, alg = run_main_path(ctxs, teams, coll, count,
                                                 dst_count, root, seed)
        launches = {k: w.launches for k, (w, _) in kernels.items()}
        log(f"main path {coll} {count} f32/rank in: launches {launches}")
        if launches[kname] <= 0:
            raise AssertionError(f"the main path's {coll} at {count} "
                                 f"elements per rank never launched {kname}")
        if alg != "ring_cuda":
            raise AssertionError(f"{coll} selected {alg}, not ring_cuda")
        wrapper, ref = kernels[kname]
        plain = ref(srcs, ucc.ReductionOp.SUM, root)
        check_main_result(coll, srcs, dsts, plain, root)
        bufs = dsts if coll == "BCAST" else None
        del dsts, plain
        max_err, ms, plain_ms, library_ms = measure(
            coll, wrapper, ref, srcs, dst_count, root, bufs)
        reduces = coll in ("ALLREDUCE", "REDUCE_SCATTER")
        flops = (N_RANKS - 1) * count if reduces else 0
        bound, bound_by = bound_ms(
            least_bytes(coll, N_RANKS, count, dst_count), flops)
        samples.sort()
        p50 = samples[len(samples) // 2]
        if count in (MAIN_COUNT, AG_MAIN_COUNT):
            ring_p50[(coll, "")] = p50
        # the nccl-tests conventions: the full vector's bytes over p50
        nbytes = max(count, dst_count) * 4
        algbw = nbytes / p50 / 1e9
        factor, library = CONVENTIONS[coll]
        busbw = algbw * factor
        rooted = f" from root {root}" if coll == "BCAST" else ""
        log(f"main path {coll}{rooted} {count} f32/rank in, {dst_count} out "
            f"via "
            f"{alg}: p50 {p50 * 1e3:.3f} ms (p10 "
            f"{samples[len(samples) // 10] * 1e3:.3f}, max "
            f"{samples[-1] * 1e3:.3f}) over {ITERS} rounds | algbw "
            f"{algbw:.2f} GB/s busbw {busbw:.2f} GB/s | {kname} "
            f"{ms:.3f} ms, bound {bound:.4f} ms ({bound_by}), "
            f"roofline share {bound / ms:.4f} | plain {plain_ms:.3f} ms | "
            f"{library} {library_ms:.3f} ms | launches {launches[kname]} | "
            f"card {smi}")
        source, replaces, _ = KERNELS[kname]
        records[kname] = {
            "name": kname, "route": "cuda",
            "source": f"ucc_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": launches[kname], "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": library_ms,
        }
        del srcs, bufs
        torch.cuda.empty_cache()
    for team in teams:
        team.destroy()
    for c in ctxs:
        c.destroy()
    counters = {k: w for k, (w, _) in kernels.items()}
    counters["ec_reduce"] = ker.ec_reduce
    records["ec_reduce"] = main_path_perftest(counters, smi)
    records["ring_flash_attention_fwd"] = main_path_attention(smi, ptxas)
    # the generated device collectives and tl/torch_ops's defaults
    os.environ.pop("UCC_TL_RING_CUDA_TUNE")
    records.update(main_path_gen(smi))
    wire = wire_below_the_stack(smi)
    counters.update(gen_device_ring=kgd.gen_device_ring,
                    gen_device_gen=kgd.gen_device_gen,
                    ring_flash_attention_fwd=ka.ring_flash_attention_fwd)
    main_path_defaults(smi, counters, ring_p50)

    # -- 5. training: ops over a RankMesh, and the steps on it -------------
    training = main_path_training(smi, counters)
    attention = records["ring_flash_attention_fwd"]
    # the f32 attention route's main path is now the GQA train step; every
    # kernel also carries its launches over the training phase's runs
    runs = [training["gqa"]["xla"], training["gqa"]["ring_cuda"],
            *(training[k] for k in ("mha", "dp_tp", "pipeline", "moe",
                                    "ring", "ulysses"))]
    attention["f32_route"]["launches"] = training["gqa"]["xla"][
        "f32_launches"]
    for kname, rec in records.items():
        rec["training_launches"] = sum(r["launches"].get(kname, 0)
                                       for r in runs)
    # the phase's attention is all f32: its launches are the f32 route's
    attention["f32_route"]["training_launches"] = \
        attention["training_launches"]
    attention["training_launches"] = 0

    # -- 6. core: EE, sub-teams, runtime fallback, plugins, metrics -------
    core = main_path_core(smi, counters)

    # -- 7. host: tl/shm, the host algorithms, the native core, the service
    # team behind team ids and the datatype check ---------------------------
    host = main_path_host(smi, counters, wrappers())

    # -- 8. procs: host teams across processes, and a team over the TCP
    # store -------------------------------------------------------------------
    procs = main_path_procs(smi, counters, wrappers(), ring_p50)

    # -- 9. span: device teams across processes ---------------------------
    span = main_path_span(smi, records)

    # every row of the kernel table: the f32 attention route (12b) and the
    # wire layers (11b wire) have records of their own; each carries its
    # launches over phase 6 as core_launches
    kernel_records = [records[k] for k in KERNELS] + [
        records[k] for k in ("ec_reduce", "ring_flash_attention_fwd",
                             *GEN_RECORDS.values())] + [
        attention["f32_route"], *wire]
    for rec in kernel_records:
        rec["core_launches"] = core["launches"].get(rec["name"], 0)
        rec["host_launches"] = host["launches"].get(rec["name"], 0)
        rec["procs_launches"] = procs["launches"].get(rec["name"], 0)
        rec["span_launches"] = span["launches"].get(rec["name"], 0)
        if rec["name"] in core["n4"]:
            rec["core_n4"] = core["n4"][rec["name"]]
    log(smi)
    log(json.dumps({"kernels": kernel_records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
