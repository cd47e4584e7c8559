"""Host collective task base — resumable algorithm state machines (the
port of the JAX package's ``tl/host/task.py``).

An algorithm is a Python generator: ``run()`` yields whenever it waits on
transport completions and the progress queue resumes it, the same
nonblocking semantics as UCC's GOTO-resumable phase machines.

Rank addressing: algorithms speak *group ranks* of a Subset (active sets,
the team); the task translates group rank -> team rank -> context rank
and tags messages with (team_key, epoch, coll tag, slot, sender ctx
rank).

Host buffers stay numpy inside the algorithms: zero-copy views of the
caller's storage (``tensor.numpy()``; bfloat16 as its uint16 bit
pattern), and the result is written into the caller's own buffer.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...fault import health as ft
from ...fault import inject as fault
from ...obs import metrics, watchdog
from ...schedule.task import CollTask
from ...status import RankFailedError, Status, UccError
from ...utils import profiling
from ...utils.ep_map import Subset
from .transport import SendReq


class HostCollTask(CollTask):
    """Base of every host-transport collective algorithm."""

    #: instrumented path unless post_fn finds every per-message subsystem
    #: (metrics, profiling, watchdog, fault injection, health) off
    _instr = True

    def __init__(self, init_args, team, subset: Optional[Subset] = None,
                 tag: Optional[int] = None):
        super().__init__(team=team, args=init_args.args if init_args else None)
        self.init_args = init_args
        self.tl_team = team
        self.subset = subset or team.full_subset()
        self.grank = self.subset.myrank
        self.gsize = self.subset.size
        self.tag = tag if tag is not None else team.next_coll_tag()
        self._gen = None
        #: group rank -> context rank, resolved once per peer
        self._peer_ctx = {}
        # a freshly built host task has provably committed nothing
        self.data_committed = False

    # ------------------------------------------------------------------
    def run(self):
        """Override: generator implementing the algorithm."""
        raise NotImplementedError
        yield  # pragma: no cover

    def post_fn(self) -> Status:
        # a failure before the first send is retryable (runtime fallback)
        self.data_committed = False
        # bind the per-message instrumentation once per post (a subsystem
        # enabled mid-collective takes effect at the next post)
        self._instr = (metrics.ENABLED or profiling.ENABLED or
                       watchdog.ENABLED or fault.ENABLED or ft.ENABLED)
        self._gen = self.run()
        self._advance()
        return Status.OK

    def progress_fn(self) -> None:
        self.tl_team.transport.progress()
        self._advance()

    def _advance(self) -> None:
        if self._gen is None:
            return
        try:
            next(self._gen)
        except StopIteration:
            if self.status == Status.IN_PROGRESS:
                self.status = Status.OK
            self._gen = None
        except UccError as e:
            self.status = e.status
            self._gen = None
        except Exception:  # noqa: BLE001
            # an algorithm bug must fail the task, not escape into the
            # caller's progress loop and leave peers hung
            from ...utils.log import get_logger
            get_logger("tl").exception(
                "collective algorithm %s raised", type(self).__name__)
            self.status = Status.ERR_NO_MESSAGE
            self._gen = None

    def cancel_fn(self) -> None:
        """Abort: close the generator and cancel every tracked transport
        request (posted recvs are withdrawn from the mailbox, so a late
        send cannot write into a reclaimed buffer)."""
        gen, self._gen = self._gen, None
        if gen is not None:
            try:
                gen.close()
            except Exception:  # noqa: BLE001 - best-effort teardown
                pass
        self._cancel_tracked()

    def _cancel_tracked(self, recv_only: bool = False) -> None:
        """Cancel the tracked outstanding requests (``_obs_reqs``);
        ``recv_only`` limits it to recvs still posted."""
        reqs = self.__dict__.get("_obs_reqs")
        if not reqs:
            return
        for kind, _peer, _slot, req in reqs:
            if recv_only and (kind != "recv" or req.test()):
                continue
            c = getattr(req, "cancel", None)
            if c is not None:
                try:
                    c()
                except Exception:  # noqa: BLE001
                    pass
        reqs.clear()

    def reset(self) -> None:
        # an errored post may have parked zero-copy sends of leased
        # scratch in peers' queues: finalize must then drop the lease
        if self.super_status.is_error or self.status.is_error:
            self._lease_tainted = True
        super().reset()
        self._gen = None
        # a persistent re-post takes a fresh team-wide tag; tuple tags
        # (active set, service) stay, per-key FIFO keeps posts ordered
        if isinstance(self.tag, int):
            self.tag = self.tl_team.next_coll_tag()

    # ------------------------------------------------------------------
    # scratch leasing (mc/pool; task-lifetime return)
    def scratch(self, key, shape, dtype) -> np.ndarray:
        """A typed scratch array leased from the host pool, keyed by call
        site: the same key on a later post reuses the same buffer. Valid
        until ``finalize``."""
        lease = self.__dict__.get("_lease")
        if lease is None:
            from ...mc.pool import ScratchLease, host_pool
            lease = self.__dict__["_lease"] = ScratchLease(host_pool())
        nd = np.dtype(dtype)
        if isinstance(shape, (int, np.integer)):
            shape = (int(shape),)
        count = 1
        for s in shape:
            count *= int(s)
        raw = lease.get(key, count * nd.itemsize, torch.uint8)
        return raw.numpy().view(nd).reshape(shape)

    def pack(self, key, parts, dtype) -> np.ndarray:
        """Concatenate 1-D typed views into leased scratch (the
        allocation-free ``np.concatenate`` of send payloads)."""
        total = 0
        for p in parts:
            total += p.size
        buf = self.scratch(key, max(1, total), dtype)[:total]
        off = 0
        for p in parts:
            buf[off:off + p.size] = p
            off += p.size
        return buf

    def finalize_fn(self) -> Status:
        lease = self.__dict__.pop("_lease", None)
        if lease is not None:
            # withdraw still-posted recvs before the buffers go back to
            # the pool; a task that ever failed keeps its lease out of it
            self._cancel_tracked(recv_only=True)
            if self.super_status == Status.OK and \
                    not self.__dict__.get("_lease_tainted"):
                lease.release()
        return Status.OK

    # ------------------------------------------------------------------
    # observability (cold unless UCC_STATS / UCC_PROFILE_MODE is set)
    _obs_names_cache = None

    def _obs_names(self):
        """(collective, algorithm) metric labels, computed once."""
        names = self._obs_names_cache
        if names is None:
            from ...constants import coll_type_str
            coll = self.coll_name
            if coll is None and self.args is not None:
                coll = coll_type_str(self.args.coll_type)
            names = self._obs_names_cache = (coll or "",
                                             self.alg_name or
                                             type(self).__name__)
        return names

    def _obs_track(self, kind: str, peer: int, slot: int, req) -> None:
        """Remember an outstanding request (cancel_fn withdraws it).
        Bounded: completed entries are pruned past a window."""
        reqs = self.__dict__.setdefault("_obs_reqs", [])
        if len(reqs) > 256:
            reqs[:] = [e for e in reqs if not e[3].test()]
        reqs.append((kind, peer, slot, req))

    def obs_describe(self, now=None) -> dict:
        d = super().obs_describe(now)
        d["grank"] = self.grank
        d["gsize"] = self.gsize
        d["tag"] = str(self.tag)
        reqs = self.__dict__.get("_obs_reqs")
        if reqs:
            reqs[:] = [e for e in reqs if not e[3].test()]
            d["outstanding"] = [{"kind": k, "peer": p, "slot": s}
                                for k, p, s, _ in reqs[:64]]
            # algorithms put their round in the slot (slot_base + round),
            # so the live slot set is the stuck round
            d["round_slots"] = sorted({s for _, _, s, _ in reqs})
        return d

    def _obs_error(self, reason: str) -> None:
        if metrics.ENABLED:
            coll, alg = self._obs_names()
            metrics.inc("coll_errors", component="tl/host", coll=coll,
                        alg=alg)
        raise UccError(Status.ERR_NO_MESSAGE, reason)

    def _integrity_error(self, src, detail: str = "") -> None:
        """A delivery failed its wire checksum: record the evidence
        (metrics, watchdog, flight, health suspicion, all inside
        ``integrity.note_wire_mismatch``) and fail the collective with
        ERR_DATA_CORRUPTED naming the sender; ``_advance`` maps the raise
        onto the task status like every other UccError. *src* is the
        sender's ctx rank (None/-1 = unattributed). Also the native plan
        path's terminal (``GeneratedCollTask._run_plan``)."""
        from ... import integrity
        from ...status import DataCorruptedError
        core = getattr(self.tl_team, "core_team", None)
        ctx = getattr(core, "context", None)
        if ctx is not None and src is not None and src >= 0:
            integrity.note_wire_mismatch(ctx, src, detail)
        if metrics.ENABLED:
            coll, alg = self._obs_names()
            metrics.inc("coll_errors", component="tl/host", coll=coll,
                        alg=alg)
        ranks = (src,) if src is not None and src >= 0 else ()
        # attribution rides its own attribute: failed_ranks means "dead",
        # and one corrupt message does not make its sender dead
        self.corrupt_ranks = sorted(ranks)
        raise DataCorruptedError(detail or "data corrupted", ranks=ranks)

    # ------------------------------------------------------------------
    # p2p helpers (group-rank addressed)
    def _ctx_of(self, peer_grank: int) -> int:
        """Cached group-rank -> context-rank resolution."""
        pc = self._peer_ctx
        ctx = pc.get(peer_grank)
        if ctx is None:
            ctx = pc[peer_grank] = self.tl_team._peer_ctx_rank(
                self.subset, peer_grank)
        return ctx

    def send_nb(self, peer_grank: int, data: np.ndarray, slot: int = 0):
        if not self._instr:
            self.data_committed = True
            return self.tl_team.send_nb_ctx(self._ctx_of(peer_grank),
                                            self.tag, slot, data)
        return self._send_nb_instr(peer_grank, data, slot)

    def _health_registry(self):
        core = getattr(self.tl_team, "core_team", None)
        ctx = getattr(core, "context", None)
        return getattr(ctx, "health", None)

    def _check_peer_alive(self, peer_grank: int) -> None:
        """Fail fast on a post that targets a known-dead rank (a send to
        it would go into a mailbox nobody drains, and the peer side
        would wait out the watchdog): raise ERR_RANK_FAILED naming it;
        the detection counts once per rank in
        ``rank_failures_detected``."""
        ctx = self._ctx_of(peer_grank)
        reg = self._health_registry()
        if fault.ENABLED and fault.killed(ctx):
            source = "inject"
        elif reg is not None and reg.is_dead(ctx):
            source = reg.dead.get(ctx, {}).get("source", "health")
        else:
            return
        ft.note_dead_target(ctx, reg, "send",
                            "post targeted a known-dead rank")
        self.failed_ranks = sorted(
            (reg.dead_set() if reg is not None else set()) | {ctx})
        raise RankFailedError(
            f"post targets failed ctx rank {ctx} ({source})", ranks={ctx})

    def _send_nb_instr(self, peer_grank: int, data: np.ndarray, slot: int):
        if ft.ENABLED or (fault.ENABLED and fault.SPEC.kill):
            self._check_peer_alive(peer_grank)
        if fault.ENABLED:
            req = self._fault_send(peer_grank, data, slot)
            if req is not None:
                return req
        self.data_committed = True
        req = self.tl_team.send_nb_ctx(self._ctx_of(peer_grank), self.tag,
                                       slot, data)
        self._send_instr(peer_grank, data, slot)
        if watchdog.ENABLED or fault.ENABLED:
            self._obs_track("send", peer_grank, slot, req)
        return req

    def _fault_send(self, peer_grank: int, data: np.ndarray, slot: int):
        """Transport-boundary injection (only under fault.ENABLED).
        Returns a substitute request, or None to send normally. The error
        action fires before data_committed flips, so a first-send error
        is retryable by the runtime fallback, as a real local transport
        failure at the post would be.

        Corruption (``corrupt=P``) is decided independently of the
        drop/error/delay lottery: one bit of a copy of the payload is
        flipped and, when wire integrity is armed, the matcher receives
        the crc32 of the ORIGINAL bytes, modelling corruption in flight.
        With integrity off the poisoned bytes are delivered silently."""
        my_ctx = getattr(self.tl_team, "_my_ctx_rank", None)
        corrupted = False
        crc = None
        if fault.SPEC.corrupt and fault.corrupt_action(my_ctx):
            data, clean_crc = fault.corrupt_send(data)
            corrupted = True
            from ... import integrity
            if integrity.WIRE:
                crc = clean_crc
        act = fault.send_action(my_ctx)
        if act is None:
            if not corrupted:
                return None
            # send here: returning None would send the clean payload
            self.data_committed = True
            req = self.tl_team.send_nb_ctx(self._ctx_of(peer_grank),
                                           self.tag, slot, data, crc=crc)
            self._obs_track("send", peer_grank, slot, req)
            return req
        if act == "error":
            self._obs_error("fault injected: send post failed")
        if act == "drop":
            # the sender proceeds and the message is lost: the receiver
            # side hang the cancellation ladder must bound
            self.data_committed = True
            return SendReq(done=True)
        _, delay_s = act
        self.data_committed = True
        proxy = fault.DelayedSendReq()
        payload = data.copy()   # the sender may reuse its buffer
        peer_ctx = self._ctx_of(peer_grank)

        def _fire(task=self, peer=peer_ctx, d=payload, s=slot, p=proxy,
                  cw=crc):
            if not p.cancelled:
                p.real = task.tl_team.send_nb_ctx(peer, task.tag, s, d,
                                                  crc=cw)
        fault.defer(delay_s, _fire)
        self._obs_track("send", peer_grank, slot, proxy)
        return proxy

    def _send_instr(self, peer_grank: int, data: np.ndarray,
                    slot: int) -> None:
        if profiling.ENABLED:
            profiling.event("tl_send", "i", span=self.seq_num,
                            peer=peer_grank, slot=slot, tag=str(self.tag),
                            nbytes=int(data.nbytes))
        if metrics.ENABLED:
            coll, alg = self._obs_names()
            metrics.inc("bytes_sent", int(data.nbytes),
                        component="tl/host", coll=coll, alg=alg)
            metrics.inc("msgs_sent", 1, component="tl/host", coll=coll,
                        alg=alg)

    def recv_nb(self, peer_grank: int, dst: np.ndarray, slot: int = 0):
        if self._instr:
            if ft.ENABLED or (fault.ENABLED and fault.SPEC.kill):
                # a recv FROM a dead rank can never complete: the same
                # fail-fast and attribution as the send side
                self._check_peer_alive(peer_grank)
            if fault.ENABLED and fault.recv_action(
                    getattr(self.tl_team, "_my_ctx_rank", None)) == "error":
                self._obs_error("fault injected: recv post failed")
        req = self.tl_team.recv_nb_ctx(self._ctx_of(peer_grank), self.tag,
                                       slot, dst)
        self.data_committed = True
        if self._instr:
            self._recv_instr(peer_grank, dst, slot)
        # recvs are always tracked: cancel_fn must be able to withdraw
        # them from the mailbox
        self._obs_track("recv", peer_grank, slot, req)
        return req

    def _recv_instr(self, peer_grank: int, dst: np.ndarray,
                    slot: int) -> None:
        if profiling.ENABLED:
            profiling.event("tl_recv", "i", span=self.seq_num,
                            peer=peer_grank, slot=slot, tag=str(self.tag),
                            nbytes=int(dst.nbytes))
        if metrics.ENABLED:
            coll, alg = self._obs_names()
            metrics.inc("bytes_recvd", int(dst.nbytes),
                        component="tl/host", coll=coll, alg=alg)
            metrics.inc("msgs_recvd", 1, component="tl/host", coll=coll,
                        alg=alg)

    def _drain_window(self, reqs):
        """Sliding-window helper of the NUM_POSTS-bounded algorithms:
        drop completed requests, failing on a delivery error as wait()
        does."""
        live = []
        for r in reqs:
            if not r.test():
                live.append(r)
            elif getattr(r, "error", None):
                if getattr(r, "corrupt_src", None) is not None:
                    self._integrity_error(r.corrupt_src, r.error or "")
                self._obs_error(f"window request failed: {r.error}")
        return live

    def _throttle(self, reqs, max_live):
        """Keep at most ``max_live`` requests outstanding, yielding while
        the window is full. Returns the surviving list."""
        while len(reqs) >= max_live:
            reqs = self._drain_window(reqs)
            if len(reqs) >= max_live:
                yield
        return reqs

    def wait(self, *reqs):
        """Yield until all requests complete; fail on delivery errors."""
        pending = [r for r in reqs if not r.test()]
        while pending:
            yield
            pending = [r for r in pending if not r.test()]
        for r in reqs:
            err = getattr(r, "error", None)
            if err:
                if getattr(r, "corrupt_src", None) is not None:
                    self._integrity_error(r.corrupt_src, err)
                self._obs_error(err)

    def sendrecv(self, send_to: int, data: np.ndarray, recv_from: int,
                 dst: np.ndarray, slot: int = 0):
        sreq = self.send_nb(send_to, data, slot)
        rreq = self.recv_nb(recv_from, dst, slot)
        yield from self.wait(sreq, rreq)
