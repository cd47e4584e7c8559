"""End-to-end data integrity in the port (``ucc_tpu_torch.integrity``,
``UCC_INTEGRITY=off|wire|verify``) against the JAX package.

Every case of the JAX package's tests/test_integrity.py runs here on the
port: the wire crc32 at the match boundary in both matchers and both
match orders, detection with sender attribution through the collective
stack (classic algorithms and native execution plans, and over the
socket frame and the arena), sampled result attestation with minority
attribution, strike escalation into quarantine and shrink, rejoin with a
clean strike slate, and UCC_QUANT composition. Where the outcome is
deterministic the JAX package runs the same inputs and the two agree:
the three crc32 implementations (the port's Python one, its C core's,
the JAX package's ``payload_crc``) on the same bytes, and the storm
drill's report. The off-mode regression probes: no checksum on any
send, no attestation bound.
"""
import time
import zlib

import numpy as np
import pytest
import torch

import ucc_tpu_torch as ut
from ucc_tpu_torch import integrity, native
from ucc_tpu_torch.fault import health, inject
from ucc_tpu_torch.status import DataCorruptedError
from ucc_tpu_torch.tl.host.transport import Mailbox, RecvReq

from torch_ft_jobs import FtJob

needs_native = pytest.mark.skipif(not native.available(),
                                  reason="native core unavailable")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("UCC_TL_RING_CUDA_DEVICE", "cpu")
    for k in ("UCC_INTEGRITY", "UCC_FT", "UCC_FAULT", "UCC_TL_SHM_TUNE",
              "UCC_GEN_NATIVE", "UCC_TL_SHM_NATIVE", "UCC_QUANT"):
        monkeypatch.delenv(k, raising=False)
    inject.reset()
    integrity.reset()
    yield
    inject.reset()
    integrity.reset()
    health.reset()


def _key(src=3, tag=7):
    # (team_key, epoch, tag, slot, sender ctx rank): the 5-tuple both
    # matchers key on; key[4] is the attribution the verifier reads
    return ("itest", 0, (1 << 20) + tag, 5, src)


def _corrupted(n=64):
    clean = np.arange(n, dtype=np.uint8)
    crc = zlib.crc32(clean) & 0xFFFFFFFF
    bad = clean.copy()
    bad[n // 2] ^= 0xFF
    return bad, crc


# ---------------------------------------------------------------------------
# wire checksum at the match boundary: python matcher, both orders
# ---------------------------------------------------------------------------

class TestWireMatchBoundaryPython:
    def test_recv_first_direct_delivery(self):
        integrity.configure(mode="wire")
        mb = Mailbox()
        rq = RecvReq(np.zeros(64, np.uint8))
        mb.post_recv(_key(), rq)
        bad, crc = _corrupted()
        sreq, kind = mb.send(_key(), bad, 8192, crc=crc)
        assert kind == "direct" and rq.done
        assert "crc32 mismatch" in rq.error
        assert rq.corrupt_src == 3

    def test_send_first_unexpected_eager(self):
        integrity.configure(mode="wire")
        mb = Mailbox()
        bad, crc = _corrupted()
        sreq, kind = mb.send(_key(src=2), bad, 8192, crc=crc)
        assert kind == "eager"
        rq = RecvReq(np.zeros(64, np.uint8))
        mb.post_recv(_key(src=2), rq)
        assert rq.done and "crc32 mismatch" in rq.error
        assert rq.corrupt_src == 2

    def test_send_first_unexpected_rndv(self):
        integrity.configure(mode="wire")
        mb = Mailbox()
        bad, crc = _corrupted(4096)
        sreq, kind = mb.send(_key(src=1), bad, 64, crc=crc)  # > eager cap
        assert kind == "rndv"
        rq = RecvReq(np.zeros(4096, np.uint8))
        mb.post_recv(_key(src=1), rq)
        assert rq.done and "crc32 mismatch" in rq.error
        assert rq.corrupt_src == 1

    def test_clean_payload_passes(self):
        # wire mode computes the crc at send when the caller passes none
        integrity.configure(mode="wire")
        mb = Mailbox()
        rq = RecvReq(np.zeros(64, np.uint8))
        mb.post_recv(_key(), rq)
        mb.send(_key(), np.arange(64, dtype=np.uint8), 8192)
        assert rq.done and rq.error is None and rq.corrupt_src is None

    def test_off_mode_unchecked_and_uncosted(self):
        # zero cost means zero checking: no checksum is computed (the
        # parked metadata stays None) and a corrupted frame is NOT flagged
        assert not integrity.ENABLED
        mb = Mailbox()
        bad, _ = _corrupted()
        mb.send(_key(src=9), bad, 8192)
        assert mb.unexpected[_key(src=9)][0].crc is None
        rq = RecvReq(np.zeros(64, np.uint8))
        mb.post_recv(_key(src=9), rq)
        assert rq.done and rq.error is None


# ---------------------------------------------------------------------------
# wire checksum at the match boundary: native (C) matcher, both orders
# ---------------------------------------------------------------------------

@needs_native
class TestWireMatchBoundaryNative:
    def test_recv_first_direct_delivery(self):
        integrity.configure(mode="wire")
        mb = native.NativeMailbox()
        try:
            rq = mb.post_recv_native(_key(), np.zeros(64, np.uint8))
            bad, crc = _corrupted()
            mb.push_native(_key(), bad, crc=crc)
            assert rq.test()
            assert rq.error and "crc32 mismatch" in rq.error
            assert rq.corrupt_src == 3
        finally:
            mb.destroy()

    def test_send_first_unexpected_eager(self):
        integrity.configure(mode="wire")
        mb = native.NativeMailbox()
        try:
            bad, crc = _corrupted()
            mb.push_native(_key(src=2), bad, crc=crc)
            rq = mb.post_recv_native(_key(src=2), np.zeros(64, np.uint8))
            assert rq.test()
            assert rq.error and "crc32 mismatch" in rq.error
            assert rq.corrupt_src == 2
        finally:
            mb.destroy()

    def test_send_first_unexpected_rndv(self):
        integrity.configure(mode="wire")
        mb = native.NativeMailbox()
        try:
            bad, crc = _corrupted(1 << 16)   # > eager cap: rndv park
            mb.push_native(_key(src=1), bad, crc=crc)
            rq = mb.post_recv_native(_key(src=1),
                                     np.zeros(1 << 16, np.uint8))
            assert rq.test()
            assert rq.error and "crc32 mismatch" in rq.error
            assert rq.corrupt_src == 1
        finally:
            mb.destroy()

    def test_clean_payload_computed_c_side(self):
        # armed mailbox + no caller crc: the C push computes the checksum
        # itself and the verify at delivery passes
        integrity.configure(mode="wire")
        mb = native.NativeMailbox()
        try:
            rq = mb.post_recv_native(_key(), np.zeros(64, np.uint8))
            mb.push_native(_key(), np.arange(64, dtype=np.uint8))
            assert rq.test() and rq.error is None
            assert rq.corrupt_src is None
        finally:
            mb.destroy()

    def test_off_mode_unchecked(self):
        assert not integrity.ENABLED
        mb = native.NativeMailbox()   # created with integrity off
        try:
            bad, _ = _corrupted()
            mb.push_native(_key(src=9), bad)
            rq = mb.post_recv_native(_key(src=9), np.zeros(64, np.uint8))
            assert rq.test() and rq.error is None
        finally:
            mb.destroy()

    def test_python_and_c_crc_agree(self):
        # the C table must be bit-identical to zlib.crc32, or a python
        # sender and a native receiver would false-positive
        integrity.configure(mode="wire")
        mb = native.NativeMailbox()
        try:
            data = np.frombuffer(bytes(range(256)) * 5, dtype=np.uint8)
            rq = mb.post_recv_native(_key(), np.zeros(data.size, np.uint8))
            mb.push_native(_key(), data.copy(),
                           crc=zlib.crc32(data) & 0xFFFFFFFF)
            assert rq.test() and rq.error is None
        finally:
            mb.destroy()


@needs_native
@pytest.mark.parametrize("nbytes", [0, 1, 255, 4096, 65539])
def test_three_crcs_agree_on_the_same_bytes(nbytes):
    """The port's Python crc, its C crc and the JAX package's
    ``payload_crc`` on the same seeded bytes: the C matcher verifies a
    delivery against the Python crc (and flags one bit off it), and a
    CPU tensor (bf16 too) digests to its bytes' crc."""
    from ucc_tpu import integrity as jintegrity
    rng = np.random.default_rng(nbytes)
    data = rng.integers(0, 256, nbytes, dtype=np.uint8)
    crc = integrity.payload_crc(data)
    assert crc == jintegrity.payload_crc(data) == \
        zlib.crc32(data.tobytes()) & 0xFFFFFFFF
    if nbytes and nbytes % 2 == 0:
        t = torch.from_numpy(data.copy()).view(torch.bfloat16)
        assert integrity.payload_crc(t) == crc
    integrity.configure(mode="wire")
    mb = native.NativeMailbox()
    try:
        rq = mb.post_recv_native(_key(), np.zeros(max(nbytes, 1), np.uint8))
        mb.push_native(_key(), data, crc=crc)
        assert rq.test() and rq.error is None
        if nbytes:
            rq = mb.post_recv_native(_key(), np.zeros(nbytes, np.uint8))
            mb.push_native(_key(), data, crc=crc ^ 1)
            assert rq.test() and rq.corrupt_src == 3
    finally:
        mb.destroy()


# ---------------------------------------------------------------------------
# end-to-end: a corrupted collective fails with attribution
# ---------------------------------------------------------------------------

def _drive_classify(job, rqs, deadline_s=10.0):
    """Drive requests to terminal; per-rank (status, ranks), ranks being
    the corruption attribution (wire errors RETURN the status with
    task.corrupt_ranks set; attestation RAISES)."""
    done = [None] * len(rqs)
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline and any(d is None for d in done):
        for c in job.contexts:
            c.progress()
        for i, rq in enumerate(rqs):
            if done[i] is not None:
                continue
            try:
                st = rq.test()
            except DataCorruptedError as e:
                done[i] = (ut.Status.ERR_DATA_CORRUPTED, sorted(e.ranks))
                continue
            if st != ut.Status.IN_PROGRESS:
                done[i] = (st, sorted(getattr(rq.task, "corrupt_ranks",
                                              ()) or ()))
    for i, rq in enumerate(rqs):
        if done[i] is None:
            rq.task.cancel(ut.Status.ERR_TIMED_OUT)
            done[i] = (ut.Status.IN_PROGRESS, [])
    return done


def _allreduce_args(count, src, dst, timeout=2.0, mem=ut.MemoryType.HOST):
    return ut.CollArgs(coll_type=ut.CollType.ALLREDUCE,
                       src=ut.BufferInfo(src, count, ut.DataType.FLOAT32,
                                         mem),
                       dst=ut.BufferInfo(dst, count, ut.DataType.FLOAT32,
                                         mem),
                       op=ut.ReductionOp.SUM, flags=ut.CollArgsFlags.TIMEOUT,
                       timeout=timeout)


def _post_all(teams, n, count, timeout=2.0):
    ins = [np.full(count, i + 1.0, np.float32) for i in range(n)]
    outs = [np.zeros(count, np.float32) for _ in range(n)]
    rqs = []
    for i, t in enumerate(teams):
        rq = t.collective_init(_allreduce_args(count, ins[i], outs[i],
                                               timeout))
        rq.post()
        rqs.append(rq)
    return rqs, outs


def _cancel_all(rqs):
    for rq in rqs:
        try:
            rq.task.cancel()
        except Exception:  # noqa: BLE001
            pass


class TestWireCollective:
    @pytest.mark.parametrize("matcher", [
        pytest.param("native", marks=needs_native), "python"])
    def test_corruptor_detected_and_attributed(self, matcher, monkeypatch):
        if matcher == "python":
            monkeypatch.setenv("UCC_TL_SHM_NATIVE", "0")
        integrity.configure(mode="wire")
        n, count = 4, 1003
        job = FtJob(n)
        rqs = []
        try:
            teams = job.create_team()
            # armed only after team create: service colls stay clean
            inject.configure("corrupt=1.0,corrupt_rank=1", seed=3)
            rqs, _ = _post_all(teams, n, count)
            done = _drive_classify(job, rqs)
            hits = [d for d in done if d[0] == ut.Status.ERR_DATA_CORRUPTED]
            assert hits, f"no rank detected the corruption: {done}"
            assert all(d[1] == [1] for d in hits), done
            # timeouts are acceptable collateral for ranks starved of the
            # corrupted contribution; hangs are not
            assert all(d[0] != ut.Status.IN_PROGRESS for d in done), done
        finally:
            _cancel_all(rqs)
            inject.reset()
            job.cleanup()

    @pytest.mark.parametrize("tier", ["socket", pytest.param(
        "ipc", marks=needs_native)])
    def test_frame_and_arena_carry_the_checksum(self, tier, monkeypatch):
        """tl/sockets' frame word and the arena's checksum word carry
        ``(1 << 32) | crc32`` under wire: a corruptor is named as on
        the in-process matchers."""
        if tier == "ipc":
            monkeypatch.setenv("UCC_TL_IPC_ENABLE", "y")
        integrity.configure(mode="wire")
        n, count = 3, 517
        job = FtJob(n, TLS=f"{tier},self")
        rqs = []
        try:
            teams = job.create_team()
            inject.configure("corrupt=1.0,corrupt_rank=1", seed=3)
            rqs, _ = _post_all(teams, n, count)
            done = _drive_classify(job, rqs)
            hits = [d for d in done if d[0] == ut.Status.ERR_DATA_CORRUPTED]
            assert hits and all(d[1] == [1] for d in hits), done
            assert all(d[0] != ut.Status.IN_PROGRESS for d in done), done
        finally:
            _cancel_all(rqs)
            inject.reset()
            job.cleanup()


@needs_native
class TestPlanWireDetection:
    def test_native_plan_round_carries_checksums(self, monkeypatch):
        """The C executor's rounds never re-enter python: the entry
        header's checksum word covers them. Peers keep NATIVE PLANS (the
        pinned corruptor interprets, which is wire-compatible), the plan
        ends ST_CORRUPT, and the harvested counter names the sender."""
        monkeypatch.setenv("UCC_GEN_NATIVE", "y")
        monkeypatch.setenv("UCC_TL_SHM_TUNE", "allreduce:@ring:inf")
        integrity.configure(mode="wire")
        n, count = 4, 1003
        job = FtJob(n)
        rqs = []
        try:
            teams = job.create_team()
            inject.configure("corrupt=1.0,corrupt_rank=1", seed=7)
            rqs, _ = _post_all(teams, n, count)
            done = _drive_classify(job, rqs)
            # probe BEFORE finalize releases the plans
            plans = [getattr(rq.task, "_plan", None) is not None
                     for rq in rqs]
            hits = [d for d in done if d[0] == ut.Status.ERR_DATA_CORRUPTED]
            assert hits and all(d[1] == [1] for d in hits), done
            # candidate selection stayed rank-invariant: the corruptor
            # interpreted, at least one detector ran the C plan
            assert plans[1] is False
            assert any(plans[i] for i in (0, 2, 3)), plans
        finally:
            _cancel_all(rqs)
            inject.reset()
            job.cleanup()


# ---------------------------------------------------------------------------
# verify mode: sampled cross-rank result attestation
# ---------------------------------------------------------------------------

def _complete_then_scribble(job, teams, n, count, victim):
    """Run an allreduce to task completion WITHOUT calling test() (so
    attestation has not started), then scribble *victim*'s result: a
    corruption past the wire (local reduce / memory)."""
    rqs, outs = _post_all(teams, n, count, timeout=10.0)
    job.progress_until(lambda: all(
        rq.task.super_status != ut.Status.IN_PROGRESS for rq in rqs))
    assert all(rq.task.super_status == ut.Status.OK for rq in rqs)
    outs[victim][count // 2] = 999.0
    return rqs


class TestAttestation:
    @pytest.mark.parametrize("n", [4, 8])
    def test_minority_digest_names_corruptor(self, n):
        integrity.configure(mode="verify", sample=1, strikes=99)
        count, victim = 256, n - 2
        job = FtJob(n)
        rqs = []
        try:
            teams = job.create_team()
            victim_ctx = teams[victim].context.rank
            rqs = _complete_then_scribble(job, teams, n, count, victim)
            done = _drive_classify(job, rqs)
            hits = [d for d in done if d[0] == ut.Status.ERR_DATA_CORRUPTED]
            # every member compares digests; the minority (1 vs n-1)
            # names the corruptor on all of them, itself included
            assert len(hits) == n, done
            assert all(d[1] == [victim_ctx] for d in hits), done
            for t in teams:
                assert integrity.strikes(t.context, victim_ctx) == 1
        finally:
            _cancel_all(rqs)
            job.cleanup()

    def test_strikes_escalate_to_quarantine(self):
        # strike budget 1: the first attested mismatch quarantines the
        # offender in every member's health registry
        health.configure("shrink", interval=0.05, timeout=2.0)
        integrity.configure(mode="verify", sample=1, strikes=1)
        n, count, victim = 4, 256, 2
        job = FtJob(n)
        rqs = []
        try:
            teams = job.create_team()
            victim_ctx = teams[victim].context.rank
            rqs = _complete_then_scribble(job, teams, n, count, victim)
            _drive_classify(job, rqs)
            for i, t in enumerate(teams):
                if i == victim:
                    continue   # the corruptor never quarantines itself
                assert victim_ctx in t.context.health.dead_set(), \
                    f"rank {i} did not quarantine ctx {victim_ctx}"
        finally:
            _cancel_all(rqs)
            job.cleanup()
            health.configure("none")

    def test_clean_results_attest_ok(self):
        integrity.configure(mode="verify", sample=1, strikes=3)
        n, count = 4, 256
        job = FtJob(n)
        try:
            teams = job.create_team()
            rqs, outs = _post_all(teams, n, count, timeout=10.0)
            assert all(rq._attest is not None for rq in rqs)
            done = _drive_classify(job, rqs)
            assert all(d[0] == ut.Status.OK for d in done), done
            for o in outs:
                assert np.allclose(o, sum(i + 1.0 for i in range(n)))
        finally:
            job.cleanup()

    def test_cuda_memory_binds_no_attestation(self):
        """A CUDA-memory collective under verify binds nothing, as the
        reference binds nothing for TPU memory (HOST only); CPU tensors
        stand for the card's here (tl/ring_cuda on the cpu device)."""
        integrity.configure(mode="verify", sample=1, strikes=3)
        n, count = 4, 64
        job = FtJob(n)
        try:
            teams = job.create_team()
            srcs = [torch.full((count,), i + 1.0) for i in range(n)]
            dsts = [torch.zeros(count) for _ in range(n)]
            rqs = [t.collective_init(_allreduce_args(
                count, srcs[i], dsts[i], 10.0, mem=ut.MemoryType.CUDA))
                for i, t in enumerate(teams)]
            assert all(rq._attest is None for rq in rqs)
            for rq in rqs:
                rq.post()
            job.progress_until(lambda: all(
                [rq.test() != ut.Status.IN_PROGRESS for rq in rqs]))
            assert all(rq.test() == ut.Status.OK for rq in rqs)
            assert all(torch.equal(d, torch.full((count,), 10.0))
                       for d in dsts)
            # the per-team sample counter did not tick: the next HOST
            # collective is sample 0, bound
            rqs, _ = _post_all(teams, n, count, timeout=10.0)
            assert all(rq._attest is not None and rq._attest.seq == 0
                       for rq in rqs)
            assert all(d[0] == ut.Status.OK
                       for d in _drive_classify(job, rqs))
        finally:
            job.cleanup()


# ---------------------------------------------------------------------------
# the full pipeline: storm -> strikes -> quarantine -> shrink -> resume
# ---------------------------------------------------------------------------

@needs_native
class TestCorruptionStormDrill:
    def test_drill_report_clean(self):
        from ucc_tpu_torch.fault.soak import run_corrupt_soak
        report = run_corrupt_soak(n_ranks=4, corrupt_rank=1, strikes=2,
                                  pre_iters=2, post_iters=8,
                                  storm_rounds_max=6, count=128)
        assert report["violations"] == [], report
        assert report["quarantined"]
        assert report["rounds_to_quarantine"] == 2
        assert report["detections"] == report["storm_rounds"]
        assert report["plan_mode"]
        assert report["post_iters"] == 8
        # survivors converged on the corruptor as the dead set
        deads = {tuple(v["dead"]) for v in report["agreed"].values()}
        assert deads == {(report["corruptor"]["ctx_rank"],)}

    def test_drill_agrees_with_the_jax_package(self):
        from ucc_tpu.fault.soak import run_corrupt_soak as jrun
        from ucc_tpu_torch.fault.soak import run_corrupt_soak as trun
        from torch_host_jobs import reference_core
        reference_core()            # C10: the reference as a process runs it
        kw = dict(n_ranks=4, corrupt_rank=2, strikes=1, pre_iters=1,
                  post_iters=6, storm_rounds_max=4, count=64)
        port, ref = trun(**kw), jrun(**kw)
        assert port["violations"] == [] == ref["violations"]
        for k in ("quarantined", "rounds_to_quarantine", "detections",
                  "storm_rounds", "corruptor", "plan_mode", "post_iters",
                  "matcher"):
            assert port[k] == ref[k], k
        # failed set, epoch and statuses of every survivor
        assert {r: (v["status"], v["dead"], v["epoch"])
                for r, v in port["agreed"].items()} == \
            {r: (v["status"], v["dead"], v["epoch"])
             for r, v in ref["agreed"].items()}
        assert sorted(k for k in port["outcomes"] if k.startswith("storm"))\
            == sorted(k for k in ref["outcomes"] if k.startswith("storm"))


# ---------------------------------------------------------------------------
# rejoin after quarantine
# ---------------------------------------------------------------------------

class TestRejoinAfterQuarantine:
    def test_quarantined_rank_rejoins_with_clean_slate(self):
        from ucc_tpu_torch.core.team import Team
        health.configure("shrink", interval=0.05, timeout=2.0)
        integrity.configure(mode="verify", sample=1, strikes=2)
        n, count, offender = 4, 64, 1
        job = FtJob(n)
        try:
            teams = job.create_team()
            offender_ctx = teams[offender].context.rank
            # trip the quarantine from rank 0's evidence (two wire strikes
            # at the verify-mode budget)
            ctx0 = teams[0].context
            integrity.note_wire_mismatch(ctx0, offender_ctx, "drill")
            integrity.note_wire_mismatch(ctx0, offender_ctx, "drill")
            assert offender_ctx in ctx0.health.dead_set()
            assert integrity.strikes(ctx0, offender_ctx) == 2

            survivors = [r for r in range(n) if r != offender]
            shrinks = {r: teams[r].shrink_post() for r in survivors}
            job.progress_until(lambda: all(
                st != ut.Status.IN_PROGRESS
                for st in [shrinks[r].test() for r in survivors]),
                timeout=20.0)
            assert all(shrinks[r].test() == ut.Status.OK for r in survivors)
            shrunk = {r: shrinks[r].new_team for r in survivors}

            # re-admit through grow + join; revive clears the ledger
            grows = {r: shrunk[r].grow_post([offender_ctx])
                     for r in survivors}
            join = Team.join_post(job.contexts[offender])
            reqs = list(grows.values()) + [join]
            job.progress_until(lambda: all(
                st != ut.Status.IN_PROGRESS
                for st in [rq.test() for rq in reqs]), timeout=30.0)
            assert all(rq.test() == ut.Status.OK for rq in reqs)
            assert offender_ctx not in ctx0.health.dead_set()
            assert integrity.strikes(ctx0, offender_ctx) == 0

            # the rebuilt full team passes a checked allreduce
            grown = [grows[r].new_team for r in survivors]
            order = sorted(survivors) + [offender]
            full = {r: (grown[survivors.index(r)] if r in survivors
                        else join.new_team) for r in order}
            ins = [np.full(count, r + 1.0, np.float32) for r in range(n)]
            outs = [np.zeros(count, np.float32) for _ in range(n)]
            rqs = []
            for r in order:
                rq = full[r].collective_init(_allreduce_args(
                    count, ins[r], outs[r], timeout=10.0))
                rq.post()
                rqs.append(rq)
            done = _drive_classify(job, rqs)
            assert all(d[0] == ut.Status.OK for d in done), done
            for o in outs:
                assert np.allclose(o, sum(r + 1.0 for r in range(n)))
            for t in list(full.values()) + list(shrunk.values()):
                t.destroy()
        finally:
            job.cleanup()
            health.configure("none")


# ---------------------------------------------------------------------------
# composition: UCC_QUANT + UCC_INTEGRITY
# ---------------------------------------------------------------------------

class TestQuantCompose:
    def test_quantized_allreduce_under_verify(self, monkeypatch):
        """Quantized traffic checksums the ENCODED bytes and the
        deterministic codec gives bit-identical results on every rank, so
        attestation agrees and the collective lands OK within the
        quantization error budget."""
        monkeypatch.setenv("UCC_QUANT", "int8")
        integrity.configure(mode="verify", sample=1, strikes=3)
        n, count = 4, 32 << 10   # >= 64K payload: quant engages
        job = FtJob(n)
        try:
            teams = job.create_team()
            rng = np.random.default_rng(5)
            ins = [rng.standard_normal(count).astype(np.float32)
                   for _ in range(n)]
            outs = [np.zeros(count, np.float32) for _ in range(n)]
            rqs = []
            for i, t in enumerate(teams):
                rq = t.collective_init(_allreduce_args(
                    count, ins[i], outs[i], timeout=20.0))
                rq.post()
                rqs.append(rq)
            assert rqs[0].task.alg_name.startswith("qint8")
            done = _drive_classify(job, rqs, deadline_s=30.0)
            assert all(d[0] == ut.Status.OK for d in done), done
            exact = np.sum(ins, axis=0)
            scale = np.max(np.abs(exact)) or 1.0
            for o in outs:
                assert np.max(np.abs(o - exact)) / scale < 0.05
            assert all(np.array_equal(o, outs[0]) for o in outs)
        finally:
            job.cleanup()


# ---------------------------------------------------------------------------
# the off-mode regression probes (tests/test_regressions.py's pair)
# ---------------------------------------------------------------------------

class TestIntegrityOffModeFree:
    """UCC_INTEGRITY=off must be free: the send path computes NO checksum
    (the parked match metadata stays None, no zlib.crc32 call) and
    collective_init binds no attestation state."""

    def test_send_path_computes_no_checksum(self, monkeypatch):
        from ucc_tpu_torch.tl.host import transport as tmod
        integrity.reset()
        assert not integrity.ENABLED
        calls = []
        real = tmod.zlib.crc32

        class _Probe:
            crc32 = staticmethod(lambda *a: calls.append(1) or real(*a))

        monkeypatch.setattr(tmod, "zlib", _Probe)
        mb = tmod.Mailbox()
        key = ("off", 0, (1 << 20) + 1, 0, 0)
        mb.send(key, np.arange(64, dtype=np.uint8), 8192)
        assert not calls, "off-mode send computed a checksum"
        assert mb.unexpected[key][0].crc is None

    def test_no_attest_bound_when_off(self):
        integrity.reset()
        n = 2
        job = FtJob(n)
        try:
            teams = job.create_team()
            dsts = [np.zeros(8, np.float64) for _ in range(n)]
            reqs = [teams[r].collective_init(ut.CollArgs(
                coll_type=ut.CollType.ALLREDUCE,
                src=ut.BufferInfo(np.ones(8), 8, ut.DataType.FLOAT64),
                dst=ut.BufferInfo(dsts[r], 8, ut.DataType.FLOAT64),
                op=ut.ReductionOp.SUM)) for r in range(n)]
            assert all(rq._attest is None for rq in reqs)
            for rq in reqs:
                rq.post()
            job.progress_until(lambda: all(
                [rq.test() != ut.Status.IN_PROGRESS for rq in reqs]))
            assert all(np.array_equal(d, np.full(8, 2.0)) for d in dsts)
        finally:
            job.cleanup()
