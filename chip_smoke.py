#!/usr/bin/env python3
"""Drive ucc_tpu_torch's main path on one NVIDIA GPU and hold its CUDA
kernels against their plain PyTorch versions.

Run from the root of a checkout, on a machine with a CUDA GPU and nvcc:

    python3 chip_smoke.py

Phases, each printing its own lines (any failure exits non-zero):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the time to build the kernels from ucc_tpu_torch/csrc/;
2. kernels: both ring allreduce kernels, n in {2, 4, 8}, f32/bf16/int32,
   SUM/AVG/MAX/MIN/PROD, ragged counts, NaN inputs for MAX/MIN, each
   launch bitwise equal to the plain version on the same CUDA tensors;
3. main path: 8 contexts over a ThreadOobWorld, one team, a persistent
   allreduce SUM of 16 Mi f32 (64 MiB) per rank driven like bench.py
   (5 warm-up and 20 timed rounds), then one of 64 Ki f32 per rank; each
   checked against torch.stack(srcs).sum(0) and, bitwise, against the
   plain version; the launch counters of each run;
4. yardstick: torch.stack(srcs).sum(0) on the same buffers (library_ms),
   which the package never calls.

The last two lines are the kernels record and {"ok": true, "device": ...}.
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

N_RANKS = 8
MAIN_COUNT = 16 << 20        # 64 MiB of f32 per rank (bench.py's count)
SMALL_COUNT = 64 << 10       # 64 Ki f32 per rank: the one-pass kernel
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
        return bool(torch.equal(a, b))
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False
    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return bool(torch.equal(a.view(view)[~na], b.view(view)[~nb]))


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps runs, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
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
    if dtype == torch.int32:
        return [torch.randint(-50, 50, (count,), generator=g, device="cuda",
                              dtype=torch.int32) for _ in range(n)]
    srcs = [torch.randn(count, generator=g, device="cuda").to(dtype)
            for _ in range(n)]
    if op in (ReductionOp.MAX, ReductionOp.MIN):
        srcs[1][3] = float("nan")
    return srcs


def check_kernel(wrapper, ref, srcs, op, inplace=False) -> float:
    """Launch the kernel and compare it bitwise with the plain version on
    the same tensors; returns the max abs difference (0.0 when equal)."""
    import torch
    want = ref(srcs, op)
    dsts = [s.clone() for s in srcs] if inplace else \
        [torch.full_like(s, 7) for s in srcs]
    wrapper(dsts if inplace else srcs, dsts, op).wait()
    torch.cuda.synchronize()
    for r, (d, w) in enumerate(zip(dsts, want)):
        if not bits_equal(d, w):
            diff = (d.double() - w.double()).abs().nan_to_num(0).max().item()
            raise AssertionError(
                f"{wrapper.__name__} n={len(srcs)} {srcs[0].dtype} {op.name} "
                f"count={srcs[0].numel()}: rank {r} differs from the plain "
                f"version (max abs diff {diff})")
    return max((d.double() - w.double()).abs().nan_to_num(0).max().item()
               for d, w in zip(dsts, want))


def phase_kernels() -> None:
    import torch
    from ucc_tpu_torch import ReductionOp, Status, UccError
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
    # a fault must raise: a workspace whose error word is already set makes
    # every spin give up and the wrapper report it
    ws = kr.RingWorkspace(torch.device("cuda"))
    ws.get(0, 0)
    ws.err.fill_(1)
    srcs = make_inputs(4, 4096, torch.float32, ReductionOp.SUM, 7)
    try:
        kr.ring_allreduce_pass(srcs, [torch.empty_like(s) for s in srcs],
                               ReductionOp.SUM, workspace=ws).wait()
    except UccError as e:
        if e.status != Status.ERR_TIMED_OUT:
            raise
    else:
        raise AssertionError("a set error word did not make the wrapper "
                             "raise")
    log(f"kernels: {cases} launches bitwise equal to their plain versions "
        f"(n in 2,4,8; f32/bf16/int32 x SUM/AVG/MAX/MIN/PROD; ragged counts; "
        f"NaN for MAX/MIN; f16, int64, in-place) in "
        f"{time.perf_counter() - t0:.1f} s; a set error word raises")


def make_job(n):
    import ucc_tpu_torch as ucc
    world = ucc.ThreadOobWorld(n)
    libs = [ucc.init() for _ in range(n)]
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
    return ctxs, teams


def run_main_path(ctxs, teams, count, seed):
    """Persistent allreduce SUM of `count` f32 per rank through the whole
    stack; returns (per-round host seconds, srcs, dsts, alg name)."""
    import torch
    import ucc_tpu_torch as ucc
    n = len(teams)
    g = torch.Generator(device="cuda").manual_seed(seed)
    srcs = [torch.randn(count, generator=g, device="cuda") for _ in range(n)]
    dsts = [torch.empty_like(s) for s in srcs]
    reqs = [teams[r].collective_init(ucc.CollArgs(
        coll_type=ucc.CollType.ALLREDUCE, op=ucc.ReductionOp.SUM,
        src=ucc.BufferInfo(srcs[r], count, ucc.DataType.FLOAT32),
        dst=ucc.BufferInfo(dsts[r], count, ucc.DataType.FLOAT32),
        flags=ucc.CollArgsFlags.PERSISTENT)) for r in range(n)]
    alg = reqs[0].task.alg_name

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
                raise RuntimeError("allreduce did not complete in 60 s")
        bad = [s for s in sts if s != ucc.Status.OK]
        if bad:
            raise RuntimeError(f"allreduce failed: {bad[0]}")

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
    return samples, srcs, dsts, alg


def check_main_result(srcs, dsts, plain) -> None:
    import torch
    want = torch.stack(srcs).sum(0)
    for r, (d, p) in enumerate(zip(dsts, plain)):
        if not torch.isfinite(d).all():
            raise AssertionError(f"rank {r}: non-finite result")
        if not torch.allclose(d, want, rtol=MAIN_RTOL, atol=MAIN_ATOL):
            err = (d - want).abs().max().item()
            raise AssertionError(f"rank {r}: differs from stack().sum(0) by "
                                 f"{err}")
        if not bits_equal(d, p):
            raise AssertionError(f"rank {r}: not bitwise the plain version")


def bound_ms(n, count, elem) -> float:
    """Least time for an allreduce of n ranks x count elements: read every
    input once, write every output once, at the HBM rate; or do the
    (n-1)*count adds at the f32 rate, whichever is longer."""
    bytes_ = 2 * n * count * elem
    return max(bytes_ / HBM_BYTES_PER_S, (n - 1) * count / F32_FLOPS) * 1e3


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
        from ucc_tpu_torch.kernels import ring_allreduce as kr
    except ImportError as e:
        print(f"chip_smoke: ucc_tpu_torch not importable here: {e}",
              file=sys.stderr)
        return 2

    # -- 1. device -------------------------------------------------------
    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"CUDA {torch.version.cuda} | python {sys.version.split()[0]}")
    build_s = build.build_all([kr.SOURCE])
    log(f"build: {kr.SOURCE} -> {build.BUILD_DIR} in {build_s:.1f} s")

    # -- 2. kernels against their plain versions ---------------------------
    phase_kernels()

    # -- 3. main path ----------------------------------------------------
    os.environ["UCC_TL_RING_CUDA_TUNE"] = "allreduce:@ring_cuda:inf"
    t0 = time.perf_counter()
    ctxs, teams = make_job(N_RANKS)
    log(f"job: {N_RANKS} contexts + team in {time.perf_counter() - t0:.1f} s")
    records = {}
    for kname, count, seed in (("ring_allreduce_chunked", MAIN_COUNT, 11),
                               ("ring_allreduce_pass", SMALL_COUNT, 12)):
        kr.ring_allreduce_pass.launches = 0
        kr.ring_allreduce_chunked.launches = 0
        samples, srcs, dsts, alg = run_main_path(ctxs, teams, count, seed)
        launches = {"ring_allreduce_pass": kr.ring_allreduce_pass.launches,
                    "ring_allreduce_chunked":
                        kr.ring_allreduce_chunked.launches}
        log(f"main path {count} f32/rank: launches {launches}")
        if launches[kname] <= 0:
            raise AssertionError(f"the main path at {count} elements per "
                                 f"rank never launched {kname}")
        wrapper = getattr(kr, kname)
        ref = getattr(kr, kname + "_ref")
        plain = ref(srcs, ucc.ReductionOp.SUM)
        check_main_result(srcs, dsts, plain)
        # the kernel alone and its yardsticks on the same buffers
        out = [torch.empty_like(s) for s in srcs]
        max_err = check_kernel(wrapper, ref, srcs, ucc.ReductionOp.SUM)
        # timed with its workspace and pointer table built once, as the
        # team's persistent launches reuse them
        ws = kr.RingWorkspace(srcs[0].device)
        table = kr.make_ptr_table(srcs, out)
        ms = cuda_ms(lambda: wrapper(srcs, out, ucc.ReductionOp.SUM,
                                     workspace=ws, ptr_table=table), 20)
        plain_ms = cuda_ms(lambda: ref(srcs, ucc.ReductionOp.SUM), 3)
        library_ms = cuda_ms(lambda: torch.stack(srcs).sum(0), 20)
        bound = bound_ms(N_RANKS, count, 4)
        samples.sort()
        p50 = samples[len(samples) // 2]
        nbytes = count * 4
        algbw = nbytes / p50 / 1e9
        busbw = algbw * 2 * (N_RANKS - 1) / N_RANKS
        log(f"main path {count} f32/rank via {alg}: p50 {p50 * 1e3:.3f} ms "
            f"(p10 {samples[len(samples) // 10] * 1e3:.3f}, max "
            f"{samples[-1] * 1e3:.3f}) over {ITERS} rounds | algbw "
            f"{algbw:.2f} GB/s busbw {busbw:.2f} GB/s | kernel "
            f"{ms:.3f} ms, bound {bound:.4f} ms (bytes, 3.35 TB/s), "
            f"roofline share {bound / ms:.4f} | plain {plain_ms:.3f} ms | "
            f"stack().sum(0) {library_ms:.3f} ms | card {smi}")
        records[kname] = {
            "name": kname, "route": "cuda",
            "source": "ucc_tpu_torch/csrc/ring_allreduce.cu",
            "replaces": ("ucc_tpu/tl/ring_dma.py:966"
                         if kname == "ring_allreduce_chunked"
                         else "ucc_tpu/tl/ring_dma.py:285"),
            "launches": launches[kname], "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": library_ms,
        }
        del srcs, dsts, plain, out
        torch.cuda.empty_cache()
    for team in teams:
        team.destroy()
    for c in ctxs:
        c.destroy()

    log(smi)
    log(json.dumps({"kernels": [records["ring_allreduce_pass"],
                                records["ring_allreduce_chunked"]]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
