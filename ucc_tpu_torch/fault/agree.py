"""Fault-tolerant agreement — survivors converge on (failed set, epoch).

The *agree* step of the recovery pipeline (detect → attribute → agree →
shrink → resume): before a team can shrink, every surviving rank must
adopt the SAME failed-rank set and recovery epoch, or the rebuilt teams
diverge in membership and deadlock their first collective. Unlike an
OOB allgather, this one runs while some members are DEAD, so it routes
around them: a simplified, ULFM-agreement-shaped protocol over the
service team's transport.

Protocol (rounds in lockstep, slot = round):

1. Each participant sends its current view ``(dead set, epoch)`` to
   every rank it believes alive, and posts recvs from the same set.
2. Arriving views are unioned in; a peer that becomes known-dead
   mid-round (named by another view, fail-fast ERR_RANK_FAILED on the
   post, or round-deadline expiry) has its pending recv cancelled and
   joins the dead set.
3. A round where every received view equals the sender's own view
   terminates the protocol. Termination is symmetric: if any rank
   observes all-equal(S), every survivor sent S that round, so every
   survivor observes all-equal(S) and stops at the same round. A
   non-terminal round grows someone's set, and sets are bounded by the
   team size, so the protocol converges in <= size+2 rounds absent new
   failures.
4. The agreed epoch is ``max(all exchanged epochs) + 1`` — identical
   everywhere because the exchanged views are identical.

Elastic extension: views carry an *admit* proposal alongside the
dead set — ``(dead set, admit set, epoch)`` — so the same protocol that
agrees on who left also agrees on who JOINS (``Team.grow``). Admit sets
union exactly like dead sets and termination requires all-equal on both,
so every survivor adopts the same (dead, admit, epoch) triple.

The mis-suspicion race (a slow-but-alive survivor whose agreement
sends land after a peer's round deadline was condemned and excluded)
is folded against fresh health evidence: at deadline expiry a
pending peer whose heartbeat stamp is FRESH (``HealthRegistry.is_fresh``)
is granted up to ``UCC_FT_AGREE_GRACE`` deadline extensions instead of
being suspected; only heartbeat-stale peers are condemned immediately.
Suspicion stays monotone (a rank once added to the dead view is never
removed — un-suspecting would break the all-equal convergence
argument), so the fix is purely about *not adding* a rank the local
failure detector can still vouch for. When exclusion happens anyway
(grace exhausted, cross-process peer with no board stamp), the recovery
path is grow-based re-admission: the excluded survivor rejoins through
``Team.join`` on the next epoch.
"""
from __future__ import annotations

import os
import time
from typing import Iterable, Optional, Set

import numpy as np

from ..status import RankFailedError, Status, UccError
from ..tl.host.task import HostCollTask
from ..utils.log import get_logger
from . import health

logger = get_logger("fault")

#: slot base for agreement rounds: far above any algorithm's round slots
#: (they top out in the hundreds) so a tuple-tagged agreement can never
#: collide with service-collective traffic on the same team
_AGREE_SLOT_BASE = 7000

#: wire-format capacity for admit proposals: a fixed slab so every
#: participant computes the same buffer size without negotiating it
#: (grow batches are small — a handful of joiners per epoch, never a
#: team's worth)
_ADMIT_CAP = 32


class _NextEpochView:
    """The service TL team as the agreement sees it: every message keyed
    one epoch above the team's. A survivor that has agreed fences the old
    epoch of the team's tag spaces, and on tl/ipc that fence is arena-wide
    (every process attached to the arena): keyed at the old epoch, a
    slower survivor's last agreement round, still in flight, would be
    purged with the stale traffic, and that survivor would take its peers
    for dead. The retired team never posts at the next epoch, so nothing
    else lives in that space."""

    def __init__(self, team, epoch: int):
        self._team = team
        self.team_epoch = int(epoch)

    def __getattr__(self, name):
        return getattr(self._team, name)

    def send_nb_ctx(self, peer_ctx: int, coll_tag, slot: int, data,
                    crc=None):
        t = self._team
        return t.comp_context.send_to(
            peer_ctx, (t.team_key, self.team_epoch, coll_tag, slot,
                       t._my_ctx_rank), data, crc=crc)

    def recv_nb_ctx(self, peer_ctx: int, coll_tag, slot: int, dst):
        t = self._team
        return t.transport.recv_nb(
            (t.team_key, self.team_epoch, coll_tag, slot, peer_ctx), dst)


def _agree_grace() -> int:
    """Max round-deadline extensions granted to a heartbeat-fresh peer
    before the last-resort suspicion fires anyway (``UCC_FT_AGREE_GRACE``,
    bounded so a wedged-but-beating process cannot stall agreement
    forever)."""
    try:
        return max(0, int(os.environ.get("UCC_FT_AGREE_GRACE", "") or 3))
    except ValueError:
        return 3


class FtAgreement(HostCollTask):
    """Agreement task posted on the (old) team's service TL team by every
    survivor. On success, ``result_dead`` holds the agreed failed set in
    TEAM ranks, ``result_admit`` the agreed joiner set in CONTEXT ranks
    (empty for plain shrink agreement), and ``result_epoch`` the agreed
    next epoch."""

    coll_name = "ft_agree"
    alg_name = "flood"

    #: recovery traffic must not be cancelled by the health scan for
    #: depending on a team with dead members — routing around them is
    #: its entire job
    _ft_exempt = True

    def __init__(self, service_team, local_dead: Iterable[int],
                 epoch: int, round_timeout_s: float = 0.0,
                 proposal: Optional[Iterable[int]] = None,
                 kind: str = "shrink"):
        super().__init__(None, service_team)
        self.local_dead: Set[int] = {int(r) for r in local_dead}
        #: ctx ranks proposed for admission (grow); capped by the wire
        #: format — a batch this large is a topology change, not a grow
        self.local_admit: Set[int] = {int(r) for r in (proposal or ())}
        if len(self.local_admit) > _ADMIT_CAP:
            raise UccError(
                Status.ERR_NOT_SUPPORTED,
                f"grow proposal of {len(self.local_admit)} joiners "
                f"exceeds the agreement wire capacity ({_ADMIT_CAP})")
        self.kind = kind
        self.base_epoch = int(epoch)
        # the round deadline is the last-resort failure detector for
        # peers dying mid-agreement; default: comfortably above the
        # heartbeat timeout so ordinary detection wins
        self.round_timeout_s = round_timeout_s or max(
            1.0, 4 * health.HEARTBEAT_TIMEOUT)
        # kind scopes the tag so a shrink and a grow agreement on the
        # same base epoch can never cross-match
        self.tag = ("ftagree", kind, self.base_epoch)
        self.tl_team = _NextEpochView(service_team, self.base_epoch + 1)
        self.result_dead: Optional[Set[int]] = None
        self.result_admit: Optional[Set[int]] = None
        self.result_epoch: Optional[int] = None

    # ------------------------------------------------------------------
    # wire format (int64): [n_dead, epoch, dead padded to gsize,
    #                       n_admit, admit padded to _ADMIT_CAP]
    def _buf_len(self) -> int:
        return self.gsize + 3 + _ADMIT_CAP

    def _pack(self, dead: Set[int], admit: Set[int],
              epoch: int) -> np.ndarray:
        buf = np.full(self._buf_len(), -1, dtype=np.int64)
        buf[0] = len(dead)
        buf[1] = epoch
        for i, r in enumerate(sorted(dead)):
            buf[2 + i] = r
        base = 2 + self.gsize
        buf[base] = len(admit)
        for i, r in enumerate(sorted(admit)):
            buf[base + 1 + i] = r
        return buf

    def _unpack(self, buf: np.ndarray):
        n = int(buf[0])
        base = 2 + self.gsize
        na = int(buf[base])
        dead = {int(r) for r in buf[2:2 + n]}
        admit = {int(r) for r in buf[base + 1:base + 1 + na]}
        return dead, admit, int(buf[1])

    def _is_fresh(self, peer_grank: int) -> bool:
        """Fresh-heartbeat check for the round-deadline race fix; False
        when no registry is wired (UCC_FT off) or no evidence exists."""
        reg = self._health_registry()
        if reg is None:
            return False
        try:
            return reg.is_fresh(self._ctx_of(peer_grank))
        except Exception:  # noqa: BLE001 - liveness lookup is best-effort
            return False

    def run(self):
        size, me = self.gsize, self.grank
        my: Set[int] = set(self.local_dead)
        my.discard(me)
        admit: Set[int] = set(self.local_admit)
        epoch = self.base_epoch
        grace = _agree_grace()
        for rnd in range(size + 2):
            sent = (frozenset(my), frozenset(admit))
            alive = [p for p in range(size) if p != me and p not in my]
            if not alive:
                break   # sole survivor: my view is the agreement
            payload = self._pack(my, admit, epoch)
            rbufs = {}
            rreqs = {}
            for p in list(alive):
                try:
                    rbufs[p] = np.full(self._buf_len(), -1, dtype=np.int64)
                    rreqs[p] = self.recv_nb(p, rbufs[p],
                                            slot=_AGREE_SLOT_BASE + rnd)
                    self.send_nb(p, payload, slot=_AGREE_SLOT_BASE + rnd)
                except RankFailedError:
                    # fail-fast attribution fired between the alive
                    # computation and the post: adopt it (in TEAM ranks —
                    # the exception carries ctx ranks) and route on
                    my.add(p)
                    req = rreqs.pop(p, None)
                    if req is not None:
                        req.cancel()
                    rbufs.pop(p, None)
            got = {}
            deadline = time.monotonic() + self.round_timeout_s
            extensions = grace
            while rreqs:
                yield
                for p, rq in list(rreqs.items()):
                    if p in my:
                        # named dead by an arrived view mid-round
                        rq.cancel()
                        del rreqs[p]
                        continue
                    if not rq.test():
                        continue
                    del rreqs[p]
                    if getattr(rq, "error", None):
                        my.add(p)   # errored delivery = failed peer
                        continue
                    peer_dead, peer_admit, peer_epoch = \
                        self._unpack(rbufs[p])
                    got[p] = (peer_dead, peer_admit)
                    epoch = max(epoch, peer_epoch)
                    my |= peer_dead
                    my.discard(me)
                    admit |= peer_admit
                if rreqs and time.monotonic() > deadline:
                    # last-resort detector, folded against fresh health
                    # evidence: a pending peer whose
                    # heartbeat is still fresh is granted a bounded
                    # deadline extension instead of being condemned —
                    # only heartbeat-stale peers are suspected outright
                    fresh = [p for p in rreqs if self._is_fresh(p)]
                    for p, rq in list(rreqs.items()):
                        if p in fresh and extensions > 0:
                            continue
                        logger.warning(
                            "ft agreement round %d: rank %d unresponsive "
                            "past %.1fs%s; suspecting it failed", rnd, p,
                            self.round_timeout_s,
                            " (grace exhausted)" if p in fresh else "")
                        my.add(p)
                        rq.cancel()
                        del rreqs[p]
                    if rreqs and extensions > 0:
                        extensions -= 1
                        deadline = time.monotonic() + self.round_timeout_s
                        logger.info(
                            "ft agreement round %d: extending deadline "
                            "for heartbeat-fresh rank(s) %s (%d grace "
                            "extension(s) left)", rnd, sorted(rreqs),
                            extensions)
            if sent == (frozenset(my), frozenset(admit)) and all(
                    v == sent for p, v in got.items() if p not in my):
                self.result_dead = set(my)
                self.result_admit = set(admit)
                self.result_epoch = epoch + 1
                logger.info(
                    "ft agreement converged in %d round(s): dead=%s "
                    "admit=%s epoch=%d", rnd + 1, sorted(my),
                    sorted(admit), self.result_epoch)
                return
        if len(my) >= size - 1:
            # everyone else is (believed) dead; trivially agreed
            self.result_dead = set(my)
            self.result_admit = set(admit)
            self.result_epoch = epoch + 1
            return
        raise UccError(Status.ERR_TIMED_OUT,
                       "ft agreement did not converge")
