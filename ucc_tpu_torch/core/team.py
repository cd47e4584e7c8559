"""Team — a group of ranks that can run collectives.

Creation is UCC's nonblocking state machine (ucc_team_create_test):

    ADDR_EXCHANGE -> SERVICE_TEAM -> ALLOC_ID -> CL_CREATE -> CL_AGREE
    -> TUNER_SYNC -> ACTIVE

- ADDR_EXCHANGE: per-team OOB allgather of context ranks -> ``ctx_map``,
  plus a process-unique team key (leader's context counter).
- SERVICE_TEAM: internal TL team providing service collectives for the
  core: tl/self for a 1-rank team, tl/shm for a larger team whose ranks
  share a process, none when no loaded TL accepts the team.
- ALLOC_ID: a nonblocking service allreduce(MAX) over every member's
  proposal (its context's counter), so all members agree on a fresh id
  and move their counters past it. A 1-rank team, and a team with no
  service team, takes its context's counter.
- CL_CREATE: create each CL's team; failures fall back to remaining CLs.
- CL_AGREE: one OOB round keeps only the CLs that exist on every member;
  then the team's topology (``TeamTopo`` over its ``ctx_map``) is built.
- TUNER_SYNC: under UCC_TUNER=offline|online, a multi-rank team syncs the
  tuning cache: rank 0 loads its cache file and bcasts the entries that
  match the team's topology signature over the service team, and every
  rank compiles exactly that payload into its score map (per-rank reads
  of a per-node file could diverge); ``online`` also attaches the
  explorer as ``team.tuner``. With the tuner off no round is posted and
  the state passes straight through. Under UCC_COLL_TRACE it then logs
  the score map (learned rows with their provenance) and each CL's
  resolved topology.
- ACTIVE: merge all CL scores into the team score map.

Membership changes (UCC_FT=shrink): ``shrink_post`` agrees with the other
survivors on the dead set and the next epoch (fault/agree.py), fences the
old epoch's tag spaces and rebuilds a successor over the survivors;
``grow_post`` admits joiner contexts that call ``Team.join_post``. The
successor bootstraps over the service team's transport
(``core/oob.TransportOob``), since the parent OOB may hold dead members,
and carries the new ``epoch`` into every match key and device rendezvous.
"""
from __future__ import annotations

import enum
import os
import pickle
import time
from typing import Any, Dict, Iterable, List, Optional, Set

import numpy as np

from ..api.types import OobRequest, TeamAttr, TeamParams
from ..constants import ReductionOp
from ..obs import metrics, watchdog
from ..score.score import CollScore
from ..score.score_map import ScoreMap
from ..status import Status, UccError
from ..topo.topo import TeamTopo
from ..utils.ep_map import EpMap
from ..utils.log import get_logger
from .context import Context

logger = get_logger("core")


class TeamState(enum.IntEnum):
    ADDR_EXCHANGE = 0
    SERVICE_TEAM = 1
    ALLOC_ID = 2
    CL_CREATE = 3
    CL_AGREE = 4
    ACTIVE = 5
    FAILED = 6
    #: tuning-cache sync (UCC_TUNER=offline|online, multi-rank teams):
    #: rank 0 bcasts its view of the cache so every rank compiles the
    #: same learned entries; no round when the tuner is off
    TUNER_SYNC = 7


class Team:
    """ucc_team_h. Construct via Context.create_team_post()."""

    #: set by a shrink or grow once the members agreed and fenced: the old
    #: epoch's tag space is dead, new collectives go to the successor
    _shrunk = False
    #: which membership change retired this team ("shrink"/"grow")
    _retired_by = None
    #: grow attempts: scope the joiner bootstrap's tag space, so a retried
    #: grow cannot cross-match a failed attempt's traffic
    _grow_attempts = 0
    _destroyed = False
    #: per-team flight-recorder sequence (obs/flight.py), bumped once per
    #: collective post in program order: the same on every member by the
    #: ordered-issue rule, so it is the key the diagnosis joins ranks on
    flight_seq = 0
    #: online tuner (score/tuner.OnlineTuner), attached at activation when
    #: UCC_TUNER=online; None (class attr, no cost) otherwise — dispatch
    #: reads it once per collective INIT
    tuner = None
    #: small-collective coalescer (core/coalesce.TeamCoalescer), attached
    #: at activation when UCC_COALESCE=y and the team has a full-membership
    #: host TL; None (class attr, no cost) otherwise, so the off path
    #: dispatches as it would without the coalescer
    coalescer = None
    #: straggler feedback table (obs/collector.RankBias), attached when
    #: the continuous collector watches this team; None (class attr, no
    #: cost) otherwise — dispatch ticks and consults it per INIT
    rank_bias = None
    #: CONTEXT ranks flagged slow at team create (the union of every
    #: member's collector view, agreed over the address exchange):
    #: cl/hier demotes them from hier-tree leader positions. Empty for
    #: ep_map teams, which skip the exchange
    boot_flagged_ctx = frozenset()

    def __init__(self, context: Context, params: Optional[TeamParams] = None):
        self.context = context
        self.params = params or TeamParams()
        p = self.params
        self.oob = p.oob
        if self.oob is not None:
            self.rank = self.oob.oob_ep
            self.size = self.oob.n_oob_eps
        elif p.ep_map is not None:
            self.ep_map = p.ep_map
            if p.ep is not None:
                self.rank = p.ep
            else:
                try:
                    self.rank = p.ep_map.local_rank(context.rank)
                except KeyError:
                    raise UccError(Status.ERR_INVALID_PARAM,
                                   f"context rank {context.rank} is not in "
                                   "the team ep_map") from None
            self.size = p.ep_map.ep_num
        else:
            self.rank = 0
            self.size = 1
        self.ctx_map: Optional[EpMap] = None
        #: the team's topology, built at CL_AGREE (cl/hier builds its own
        #: from ctx_map before that)
        self.topo: Optional[TeamTopo] = None
        self.team_key: Any = None
        self.id: Optional[int] = p.id
        #: recovery epoch: 0 for a team that never changed membership,
        #: bumped by shrink and grow and stamped into every host-transport
        #: match key (epoch fences) and device rendezvous key
        self.epoch: int = int(getattr(p, "epoch", 0) or 0)
        self.state = TeamState.ADDR_EXCHANGE
        #: QoS priority class (progress-queue lane): explicit create param
        #: wins, else the UCC_TEAM_PRIORITY env, else the middle class
        from ..schedule.progress import DEFAULT_PRIORITY, clamp_priority
        pr = getattr(p, "priority", None)
        if pr is None:
            pr = os.environ.get("UCC_TEAM_PRIORITY", DEFAULT_PRIORITY)
        self.priority = clamp_priority(pr)
        # the watchdog names the state of a team whose create hangs
        # (a weak set: no lifetime extension)
        watchdog.register_team(self)
        self.service_team = None
        self.cl_teams: List[Any] = []
        self.score_map: Optional[ScoreMap] = None
        self.seq_num = 0            # per-team collective tag counter
        self._pending_req: Optional[OobRequest] = None
        self._pending_task = None
        self._cl_iter: Optional[List] = None
        self._cl_current = None
        self._failed_status = Status.OK
        self._start_state_machine()

    # ------------------------------------------------------------------
    # every transition stamps ``state_since`` (the watchdog's dwell) and
    # records the left state's dwell as a bootstrap span on the flight
    # ring, so a slow team create is attributable state by state
    @property
    def state(self) -> "TeamState":
        return self._state

    @state.setter
    def state(self, new_state: "TeamState") -> None:
        now = time.monotonic()
        old = getattr(self, "_state", None)
        if old is not None and old != new_state:
            dwell = now - self.state_since
            if metrics.ENABLED:
                metrics.observe("team_state_dwell_us", dwell * 1e6,
                                component="core/team", coll=old.name)
            fr = getattr(self.context, "flight", None)
            if fr is not None:
                fr.complete(self.id, self.epoch, -1, "bootstrap",
                            "team_create", f"boot:{old.name.lower()}",
                            dwell, "OK")
        self._state = new_state
        self.state_since = now

    # ------------------------------------------------------------------
    def _start_state_machine(self) -> None:
        if self.oob is not None:
            # exchange (ctx_rank, leader_counter, leader pid)
            leader_counter = -1
            if self.rank == 0:
                leader_counter = self.context._team_id_counter
                self.context._team_id_counter += 1
            # this member's collector view of flagged CONTEXT ranks rides
            # the round the team already pays for: every member sees the
            # same entries, so the union agrees by construction and
            # cl/hier can demote flagged ranks from leader positions
            col = self.context.collector
            flagged = tuple(sorted(col.flagged_ctx())) if col else ()
            payload = pickle.dumps((self.context.rank, leader_counter,
                                    self.context.proc[1], flagged))
            self._pending_req = self.oob.allgather(payload)
        else:
            # no per-team OOB: the ep_map alone defines membership. The
            # team key must be identical on every member WITHOUT
            # communication: derive it from the membership tuple plus a
            # per-membership creation counter — consistent because UCC
            # requires ordered team creation across ranks.
            self.ctx_map = getattr(self, "ep_map", None) or EpMap.full(self.size)
            members = tuple(int(self.ctx_map.eval(i))
                            for i in range(self.size))
            counters = getattr(self.context, "_epmap_team_counters", None)
            if counters is None:
                counters = self.context._epmap_team_counters = {}
            seq = counters.get(members, 0)
            counters[members] = seq + 1
            self.team_key = ("epmap", members, seq)
            self.state = TeamState.SERVICE_TEAM

    def create_test(self) -> Status:
        """ucc_team_create_test."""
        try:
            return self._create_test_inner()
        except UccError as e:
            logger.error("team create failed in state %s: %s",
                         self.state.name, e)
            self.state = TeamState.FAILED
            self._failed_status = e.status
            return e.status

    def _create_test_inner(self) -> Status:
        if self.state == TeamState.ADDR_EXCHANGE:
            req = self._pending_req
            if req is not None:
                if req.test() == Status.IN_PROGRESS:
                    return Status.IN_PROGRESS
                entries = [pickle.loads(b) for b in req.result]
                req.free()
                self._pending_req = None
                self.ctx_map = EpMap.from_array([e[0] for e in entries])
                leader = entries[0]
                # the key stays (members, counter, pid): the flagged
                # piggyback must NOT enter the tag space's identity, or
                # two creates either side of a flag change would key
                # differently across ranks
                self.team_key = (tuple(int(e[0]) for e in entries),
                                 leader[1], leader[2])
                flagged = frozenset(int(r) for e in entries for r in e[3])
                if flagged:
                    self.boot_flagged_ctx = flagged
            self.state = TeamState.SERVICE_TEAM

        if self.state == TeamState.SERVICE_TEAM:
            if self.service_team is None:
                self.service_team = self._create_service_team()
            if self.service_team is not None:
                st = self.service_team.create_test()
                if st == Status.IN_PROGRESS:
                    return Status.IN_PROGRESS
                if st.is_error:
                    raise UccError(st, "service team create failed")
            self.state = TeamState.ALLOC_ID

        if self.state == TeamState.ALLOC_ID:
            st = self._alloc_id_step()
            if st == Status.IN_PROGRESS:
                return st
            self.state = TeamState.CL_CREATE

        if self.state == TeamState.CL_CREATE:
            st = self._cl_create_step()
            if st == Status.IN_PROGRESS:
                return st
            self.state = TeamState.CL_AGREE

        if self.state == TeamState.CL_AGREE:
            st = self._cl_agree_step()
            if st == Status.IN_PROGRESS:
                return st
            self.topo = TeamTopo(self.context.topo, self.ctx_map, self.rank)
            self._build_score_map()
            # tuning-cache sync (rank 0 authoritative); activation_begin
            # posts nothing when the tuner is off. Tuning never fails a
            # team's creation
            from ..score.tuner import activation_begin
            try:
                self._pending_task = activation_begin(self)
            except Exception:  # noqa: BLE001
                logger.exception("tuner cache-sync post failed; team %s "
                                 "continues untuned", self.id)
                self._pending_task = None
            self.state = TeamState.TUNER_SYNC

        if self.state == TeamState.TUNER_SYNC:
            task = self._pending_task
            if task is not None and not task.is_completed():
                return Status.IN_PROGRESS
            self._pending_task = None
            from ..score.tuner import activation_end
            try:
                activation_end(self, task)
            except Exception:  # noqa: BLE001 - tuned is better, untuned ok
                logger.exception("tuner activation failed; team %s "
                                 "continues with the static score map",
                                 self.id)
            if self.context.lib.config.coll_trace:
                logger.info("%s", self.score_map.print_info(
                    f"team {self.id} size {self.size}"))
                # the resolved hierarchy beside the score rows: a
                # mis-detected topology shows at activation
                for cl in self.cl_teams:
                    describe = getattr(cl, "describe_topology", None)
                    if describe is not None:
                        logger.info("team %s %s topology:\n%s",
                                    self.id, cl.name, describe())
            self.state = TeamState.ACTIVE
            # small-collective coalescer (UCC_COALESCE=y): attached only
            # once the score map exists (eligibility and the fused
            # dispatch both ride it). Must never fail activation
            from .coalesce import maybe_attach as _coalesce_attach
            try:
                _coalesce_attach(self)
            except Exception:  # noqa: BLE001
                logger.exception("coalescer attach failed; team %s "
                                 "continues uncoalesced", self.id)
            # continuous telemetry: register with the context's collector
            # (None unless UCC_COLLECT=y); windows start only once the
            # team can carry the exchange
            col = self.context.collector
            if col is not None:
                try:
                    col.watch(self)
                except Exception:  # noqa: BLE001 - telemetry must never
                    # fail an otherwise activated team
                    logger.exception("collector watch failed; team %s "
                                     "continues unwatched", self.id)

        if self.state == TeamState.ACTIVE:
            return Status.OK
        if self.state == TeamState.FAILED:
            return self._failed_status if self._failed_status.is_error \
                else Status.ERR_NO_RESOURCE
        return Status.IN_PROGRESS

    # ------------------------------------------------------------------
    def _create_service_team(self):
        """The first service-capable TL that accepts this team; None when
        no loaded TL is service-capable."""
        order = sorted(
            self.context.tl_contexts.items(),
            key=lambda kv: (not kv[1].tl_lib.tl_cls.SERVICE_CAPABLE,
                            -kv[1].tl_lib.tl_cls.DEFAULT_SCORE))
        for name, handle in order:
            tl_cls = handle.tl_lib.tl_cls
            if not tl_cls.SERVICE_CAPABLE:
                continue
            try:
                return tl_cls.team_cls(handle.obj, self, scope="svc")
            except UccError:
                continue
        return None

    def _alloc_id_step(self) -> Status:
        if self.id is not None:
            return Status.OK
        if self.size == 1 or self.service_team is None or \
                not hasattr(self.service_team, "service_allreduce"):
            self.id = self.context._team_id_counter
            self.context._team_id_counter += 1
            return Status.OK
        if self._pending_task is None:
            proposal = np.array([self.context._team_id_counter],
                                dtype=np.int64)
            self._pending_task = self.service_team.service_allreduce(
                proposal, ReductionOp.MAX)
            self._pending_task.post()
        task = self._pending_task
        if not task.is_completed():
            return Status.IN_PROGRESS
        self._pending_task = None
        task.finalize()     # the service task's scratch goes back to the pool
        if task.super_status.is_error:
            raise UccError(task.super_status, "team id allreduce failed")
        new_id = int(task.result[0])
        self.id = new_id
        self.context._team_id_counter = new_id + 1
        return Status.OK

    def _cl_create_step(self) -> Status:
        if self._cl_iter is None:
            self._cl_iter = list(self.context.cl_contexts.values())
        while self._cl_iter or self._cl_current is not None:
            if self._cl_current is None:
                handle = self._cl_iter.pop(0)
                cl_cls = handle.cl_lib.cl_cls
                try:
                    self._cl_current = cl_cls.team_cls(handle.obj, self)
                except UccError as e:
                    lvl = logger.debug if e.status == Status.ERR_NOT_SUPPORTED \
                        else logger.warning
                    lvl("CL %s team create skipped: %s", cl_cls.NAME, e)
                    continue
            st = self._cl_current.create_test()
            if st == Status.IN_PROGRESS:
                return Status.IN_PROGRESS
            if st.is_error:
                logger.warning("CL %s team create failed (%s); falling back",
                               self._cl_current.name, st)
                self._cl_current.destroy()
            else:
                self.cl_teams.append(self._cl_current)
            self._cl_current = None
        # an empty set still enters CL_AGREE: peers that did create a CL
        # wait there for this rank's contribution
        return Status.OK

    def _cl_agree_step(self) -> Status:
        """Agree on the surviving CL set across the team (allgather the
        local CL name set, keep only CLs that exist EVERYWHERE), so
        asymmetric CL failures cannot leave ranks with different score
        maps. Teams without an OOB (ep_map teams) skip the round."""
        if self.size == 1 or self.oob is None:
            if not self.cl_teams:
                raise UccError(Status.ERR_NO_RESOURCE,
                               "no CL could create a team")
            return Status.OK
        if self._pending_req is None:
            names = sorted(t.name for t in self.cl_teams)
            self._pending_req = self.oob.allgather(pickle.dumps(names))
        req = self._pending_req
        if req.test() == Status.IN_PROGRESS:
            return Status.IN_PROGRESS
        per_rank = [set(pickle.loads(b)) for b in req.result]
        req.free()
        self._pending_req = None
        common = set.intersection(*per_rank) if per_rank else set()
        dropped = [t for t in self.cl_teams if t.name not in common]
        if dropped:
            logger.warning(
                "CL(s) %s created on this rank but not team-wide; "
                "dropping for a consistent score map",
                ",".join(t.name for t in dropped))
            for t in dropped:
                t.destroy()
            self.cl_teams = [t for t in self.cl_teams if t.name in common]
        if not self.cl_teams:
            raise UccError(Status.ERR_NO_RESOURCE,
                           "no CL survived team-wide agreement")
        return Status.OK

    def fail(self, status: Status = Status.ERR_TIMED_OUT,
             reason: str = "") -> None:
        """Force the create state machine into FAILED (watchdog
        escalation; a peer that will never arrive). The next
        ``create_test`` returns *status* instead of IN_PROGRESS forever
        — the bounded outcome the no-hang invariant requires. In-flight
        service tasks are cancelled so they don't linger in the
        progress queue."""
        if self.state in (TeamState.ACTIVE, TeamState.FAILED):
            return
        logger.error("team create failed by escalation in state %s: %s",
                     self.state.name, reason or status.name)
        task = self._pending_task
        if task is not None and not task.is_completed():
            task.cancel(status)
        self._failed_status = status
        self.state = TeamState.FAILED

    def _build_score_map(self) -> None:
        merged = CollScore()
        for cl_team in self.cl_teams:
            merged = merged.merge(cl_team.get_scores())
        self.score_map = ScoreMap(merged)

    # ------------------------------------------------------------------
    def get_attr(self) -> TeamAttr:
        return TeamAttr(size=self.size, ep=self.rank,
                        coll_types=self.context.lib.attr.coll_types)

    def _tl_tag_spaces(self):
        """(team_key, transport) pairs of every host TL team of this team:
        the tag spaces an epoch fence must cover (perftest also names the
        transport tier from them). Walks the service team and the CL
        teams (cl/basic's tl_teams, cl/hier's per-sbgp units and
        N-level tree units) by duck typing."""
        spaces = []

        def visit(t):
            if t is None:
                return
            tk = getattr(t, "team_key", None)
            tr = getattr(t, "transport", None)
            if tk is not None and tr is not None and \
                    hasattr(tr, "fence"):
                spaces.append((tk, tr))
            for sub in getattr(t, "tl_teams", ()) or ():
                visit(sub)
            for sub in getattr(t, "_pending", ()) or ():
                visit(sub)
            sbgps = getattr(t, "sbgps", None)
            if sbgps:
                for sub in sbgps.values():
                    visit(sub)
            for sub in getattr(t, "_extra_units", ()) or ():
                visit(sub)   # cl/hier N-level tree units

        visit(self.service_team)
        for cl in self.cl_teams:
            visit(cl)
        return spaces

    def next_tag(self) -> int:
        self.seq_num += 1
        return self.seq_num

    def collective_init(self, args):
        from .coll import collective_init
        return collective_init(args, self)

    @classmethod
    def create_from_parent(cls, parent: "Team", ranks: List[int],
                           dead: Optional[List[int]] = None,
                           epoch: Optional[int] = None,
                           admit_ctx: Optional[List[int]] = None,
                           attempt: int = 0) -> Optional["Team"]:
        """ucc_team_create_from_parent: split `parent` by explicit
        parent-team `ranks` (that order is the new team's). The new team
        is posted: drive its ``create_test()`` as any team's.

        Without *dead*/*admit_ctx* every parent rank calls it and
        non-members get None. Over a subset-capable parent OOB (a thread
        OOB, or a team split from one) non-members skip the subset's
        rounds entirely; over any other they ride along once per round
        (``SubsetOob.participate``).

        With *dead* (team ranks that will never take part again: the
        shrink rebuild) the parent OOB cannot be used, since every round
        of it waits for the dead ranks. The rebuild bootstraps instead
        over the parent's service-team transport among the survivors only
        (``TransportOob``), keyed by the recovery *epoch*; dead ranks and
        non-member survivors take no part.

        With *admit_ctx* (the grow rebuild) the members are the survivors
        in old team-rank order followed by the admitted joiner CONTEXT
        ranks, sorted; each joiner builds the same list from its invite
        (``Team.join_post``) and joins the same space, keyed by (parent
        key, epoch, *attempt*)."""
        if dead or admit_ctx:
            if (dead and parent.rank in dead) or parent.rank not in ranks:
                return None
            svc = parent.service_team
            if svc is None or getattr(svc, "transport", None) is None:
                raise UccError(
                    Status.ERR_NOT_SUPPORTED,
                    "fault-tolerant split requires a transport-backed "
                    "service team")
            from .oob import TransportOob
            ep = int(epoch) if epoch is not None else parent.epoch + 1
            member_ctx = [int(parent.ctx_map.eval(r)) for r in ranks]
            if admit_ctx:
                member_ctx += sorted(int(c) for c in admit_ctx)
                space = ("grow", parent.team_key, ep, int(attempt))
            else:
                space = ("shrink", parent.team_key, ep)
            ft_oob = TransportOob(svc.comp_context, svc.transport,
                                  member_ctx, parent.context.rank,
                                  space, ep)
            return Team(parent.context, TeamParams(oob=ft_oob, epoch=ep))
        from .oob import SubsetOob
        if parent.oob is None:
            raise UccError(Status.ERR_INVALID_PARAM,
                           "parent team has no OOB to split")
        if parent.rank not in ranks:
            # one contribution per OOB round of the members' team create
            # (a no-op each over a subset-capable parent): the address
            # exchange and, with more than one member, the CL agreement
            for _ in range(2 if len(ranks) > 1 else 1):
                SubsetOob.participate(parent.oob)
            return None
        return Team(parent.context,
                    TeamParams(oob=SubsetOob(parent.oob, ranks)))

    def destroy(self) -> Status:
        """Release the team's component teams. Safe on a half-created team
        and idempotent."""
        if self._destroyed:
            return Status.OK
        self._destroyed = True
        if self.coalescer is not None:
            # held members must reach a terminal state before their
            # transport goes away (per-request contract)
            self.coalescer.abort(Status.ERR_CANCELED)
            self.coalescer.detach()
        task, self._pending_task = self._pending_task, None
        if task is not None and not task.is_completed():
            task.cancel()
        cur, self._cl_current = self._cl_current, None
        teams = ([cur] if cur is not None else []) + list(self.cl_teams)
        self.cl_teams = []
        for cl_team in teams:
            try:
                cl_team.destroy()
            except Exception:  # noqa: BLE001 - teardown must reach the rest
                logger.exception("CL team destroy raised (teardown "
                                 "continues)")
        if self.service_team is not None:
            try:
                self.service_team.destroy()
            except Exception:  # noqa: BLE001
                logger.exception("service team destroy raised")
        return Status.OK

    # ------------------------------------------------------------------
    # rank-failure recovery (UCC_FT=shrink): detect -> agree -> shrink
    def _cancel_in_flight(self, status: Status,
                          failed_ctx_ranks: List[int]) -> int:
        """Cancel every queued task riding THIS team with *status*,
        stamping ``task.failed_ranks`` (CONTEXT ranks) for attribution.
        Recovery traffic (``_ft_exempt``) is spared. Cancellation withdraws
        posted recvs from the mailbox, taints scratch leases (dropped at
        finalize, not recycled) and, for device tasks, withdraws the
        rank's rendezvous deposit."""
        from ..fault.health import cancel_queued_tasks
        if self.coalescer is not None:
            # members held in an open batch never reached the progress
            # queue: cancel them here or the sweep below misses them
            self.coalescer.abort(status, failed_ctx_ranks)
        failed = set(failed_ctx_ranks)

        def failed_for(task):
            core = getattr(task.team, "core_team", task.team)
            return failed if core is self else None

        return cancel_queued_tasks(self.context.progress_queue,
                                   failed_for, status)

    def _fence(self, min_epoch: int) -> int:
        """Epoch-fence every tag space of this team on the LOCAL receive
        side: parked stale messages are purged (their senders' reqs
        completed, posted recvs errored) and late arrivals are discarded
        at the matching boundary — the guard that keeps a stale
        pre-shrink send out of a pool-reissued lease buffer."""
        purged = 0
        for team_key, transport in self._tl_tag_spaces():
            purged += transport.fence(team_key, min_epoch)
        fr = self.context.flight
        if fr is not None:
            fr.fence(self.team_key, min_epoch, purged)
        return purged

    def shrink_post(self, dead_hint: Optional[List[int]] = None
                    ) -> "ShrinkRequest":
        """Post a nonblocking ULFM-style shrink: agree with the other
        survivors on the failed-rank set and recovery epoch, fence the
        old epoch's tag space, and rebuild a successor team excluding
        the dead ranks. Every SURVIVING rank must call this (dead ranks
        obviously don't). Drive with ``ShrinkRequest.test()`` +
        ``context.progress()``; on OK, ``req.new_team`` is the ACTIVE
        successor and this team only accepts ``destroy()``."""
        return ShrinkRequest(self, dead_hint)

    def shrink(self, dead_hint: Optional[List[int]] = None,
               timeout: float = 60.0) -> "Team":
        """Blocking convenience over :meth:`shrink_post`. Only usable
        when other survivors progress concurrently (threads/processes);
        cooperative single-thread callers must use shrink_post."""
        req = self.shrink_post(dead_hint)
        deadline = time.monotonic() + timeout
        while req.test() == Status.IN_PROGRESS:
            self.context.progress()
            if time.monotonic() > deadline:
                raise UccError(Status.ERR_TIMED_OUT, "team shrink timed out")
        st = req.test()
        if st.is_error:
            raise UccError(st, "team shrink failed")
        assert req.new_team is not None
        return req.new_team

    def grow_post(self, new_ctx_ranks: Iterable[int],
                  timeout_s: Optional[float] = None) -> "GrowRequest":
        """Post a nonblocking grow — the symmetric twin of
        :meth:`shrink_post`: agree with the other members on the admitted
        joiner set (CONTEXT ranks) and next epoch, invite the joiners
        over the service transport, and rebuild a successor team that
        includes them. Every CURRENT member must call this with the same
        joiner set; each joiner concurrently calls :meth:`Team.join_post`
        on its own context. Drive with ``GrowRequest.test()`` +
        ``context.progress()``; on OK, ``req.new_team`` is the ACTIVE
        successor and this team only accepts ``destroy()``. On failure
        (e.g. an absent joiner) THIS team stays fully usable."""
        return GrowRequest(self, new_ctx_ranks, timeout_s)

    def grow(self, new_ctx_ranks: Iterable[int],
             timeout: float = 60.0) -> "Team":
        """Blocking convenience over :meth:`grow_post` (same concurrency
        caveat as :meth:`shrink`)."""
        req = self.grow_post(new_ctx_ranks, timeout)
        deadline = time.monotonic() + timeout
        while req.test() == Status.IN_PROGRESS:
            self.context.progress()
            if time.monotonic() > deadline:
                raise UccError(Status.ERR_TIMED_OUT, "team grow timed out")
        st = req.test()
        if st.is_error:
            raise UccError(st, "team grow failed")
        assert req.new_team is not None
        return req.new_team

    @classmethod
    def join_post(cls, context: Context,
                  timeout_s: Optional[float] = None) -> "JoinRequest":
        """Post a nonblocking join: wait for a grow invite addressed to
        this context (sent by the growing team's sponsor rank), then
        bootstrap into the successor team over the service transport.
        Needs NO parent-team handle — which is exactly what makes it the
        re-admission path for a falsely-suspected survivor whose old
        team retired without it. Drive with ``JoinRequest.test()`` +
        ``context.progress()``; on OK, ``req.new_team`` is the ACTIVE
        team this context now serves."""
        return JoinRequest(context, timeout_s)

    @classmethod
    def join(cls, context: Context, timeout: float = 60.0) -> "Team":
        """Blocking convenience over :meth:`join_post`."""
        req = cls.join_post(context, timeout)
        deadline = time.monotonic() + timeout
        while req.test() == Status.IN_PROGRESS:
            context.progress()
            if time.monotonic() > deadline:
                raise UccError(Status.ERR_TIMED_OUT, "team join timed out")
        st = req.test()
        if st.is_error:
            raise UccError(st, "team join failed")
        assert req.new_team is not None
        return req.new_team


class ShrinkRequest:
    """Nonblocking team-shrink state machine: CANCEL (at post) -> AGREE
    -> FENCE -> REBUILD -> OK. On success ``new_team`` is the ACTIVE
    successor, ``failed_ranks`` the agreed dead set (parent-team ranks),
    and ``epoch`` the successor's recovery epoch — identical on every
    survivor by construction (fault/agree.py)."""

    def __init__(self, team: Team, dead_hint: Optional[List[int]] = None):
        if team.state != TeamState.ACTIVE:
            raise UccError(Status.ERR_INVALID_PARAM,
                           "shrink of a non-active team")
        if team.size <= 1 or team.service_team is None or \
                getattr(team.service_team, "transport", None) is None:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           "shrink requires a transport-backed service "
                           "team over 2+ ranks")
        self.team = team
        self.status = Status.IN_PROGRESS
        self.new_team: Optional[Team] = None
        self.failed_ranks: Optional[List[int]] = None
        self.epoch: Optional[int] = None
        ctx = team.context
        # local dead view: health attribution (ctx ranks) + caller hint
        # (team ranks); the agreement reconciles divergent views
        local_dead = {int(r) for r in (dead_hint or ())}
        reg = getattr(ctx, "health", None)
        if reg is not None:
            dead_ctx = reg.dead_set()
            for i in range(team.size):
                if int(team.ctx_map.eval(i)) in dead_ctx:
                    local_dead.add(i)
        local_dead.discard(team.rank)
        # bound everything already in flight on the dying team NOW —
        # callers polling those requests see ERR_RANK_FAILED, attributed
        # (in ctx ranks, the failed_ranks contract everywhere else)
        team._cancel_in_flight(
            Status.ERR_RANK_FAILED,
            [int(team.ctx_map.eval(i)) for i in sorted(local_dead)])
        from ..fault.agree import FtAgreement
        self._agree = FtAgreement(team.service_team, local_dead, team.epoch)
        self._agree.progress_queue = ctx.progress_queue
        self._agree.post()
        self._state = "agree"

    def test(self) -> Status:
        if self.status != Status.IN_PROGRESS:
            return self.status
        try:
            return self._step()
        except UccError as e:
            logger.error("team shrink failed: %s", e)
            self.status = e.status
            return self.status

    def _step(self) -> Status:
        team = self.team
        if self._state == "agree":
            a = self._agree
            if not a.is_completed():
                return Status.IN_PROGRESS
            if a.super_status.is_error:
                self.status = a.super_status
                return self.status
            dead = a.result_dead or set()
            self.epoch = a.result_epoch
            self.failed_ranks = sorted(dead)
            # attribution: agreed-dead ranks this rank had not detected
            # locally become known to its health registry, so later posts
            # targeting them fail fast on every team
            reg = getattr(team.context, "health", None)
            if reg is not None:
                for tr in dead:
                    reg.report_failure(int(team.ctx_map.eval(tr)),
                                       "agreement",
                                       f"agreed dead in team {team.id} "
                                       f"shrink to epoch {self.epoch}")
            survivors = [i for i in range(team.size) if i not in dead]
            # the old epoch's tag space is now dead: fence it (purges
            # parked stale sends/recvs, discards late arrivals) and stop
            # accepting new collectives on the old team
            team._shrunk = True
            team._retired_by = "shrink"
            team._fence(self.epoch)
            fr = team.context.flight
            if fr is not None:
                fr.membership(team.id, self.epoch, "shrink",
                              f"dead={self.failed_ranks}")
            if metrics.ENABLED:
                metrics.inc("team_shrinks", component="core")
            logger.warning(
                "team %s shrinking: dead ranks %s, %d survivors, "
                "epoch %d", team.id, self.failed_ranks, len(survivors),
                self.epoch)
            self.new_team = Team.create_from_parent(
                team, survivors, dead=sorted(dead), epoch=self.epoch)
            self._state = "rebuild"
        if self._state == "rebuild":
            assert self.new_team is not None
            st = self.new_team.create_test()
            if st == Status.IN_PROGRESS:
                return st
            if st.is_error:
                self.status = st
                return st
            # telemetry across the change: the collector's straggler
            # state (scores, flags) moves to the successor instead of
            # being learned again each epoch
            _collector_handoff(team, self.new_team)
            self._state = "done"
            self.status = Status.OK
        return self.status


def _collector_handoff(old_team: Team, new_team: Team) -> None:
    """Carry the collector's straggler state from a retired team to its
    successor after a membership change (best effort: telemetry never
    fails a rebuild)."""
    col = old_team.context.collector
    if col is None:
        return
    try:
        col.handoff(old_team, new_team)
    except Exception:  # noqa: BLE001 - telemetry continuity is advisory
        logger.exception("collector handoff failed; successor team %s "
                         "restarts telemetry cold", new_team.id)


def _grow_timeout() -> float:
    """Joiner-bootstrap deadline (``UCC_FT_GROW_TIMEOUT``): how long a
    grow waits for absent joiners before rolling back with
    ``ERR_TIMED_OUT`` (the old team stays usable)."""
    try:
        return float(os.environ.get("UCC_FT_GROW_TIMEOUT", "") or 30.0)
    except ValueError:
        return 30.0


def _join_invite_key(joiner_ctx: int, phase: int):
    """Well-known invite mailbox key for *joiner_ctx*: static (no team,
    no epoch) so a joiner needs zero prior state to post its recv — the
    property that lets a falsely-excluded survivor re-admit without a
    handle to the team that excluded it. Fence-compatible shape (epoch
    slot pinned to 0; the ("ftjoin", ctx) space is never fenced)."""
    return (("ftjoin", int(joiner_ctx)), 0, 0, int(phase), 0)


def _grow_ack_key(space, epoch: int, joiner_ctx: int):
    """Joiner-liveness ack key inside the grow bootstrap tag space
    (phase 9 — TransportOob rounds use phases 0-3, so no collision):
    each joiner acks every survivor as its FIRST act after consuming the
    invite, which is what lets a timed-out grow name the absent joiner
    rather than reporting an anonymous bootstrap hang."""
    return (("ftoob", space), int(epoch), 0, 9, int(joiner_ctx))


def _service_endpoint(context: Context):
    """The context's service-capable TL context (same selection order as
    ``Team._create_service_team``): the transport endpoint a joiner
    listens on for invites and bootstraps through. The sponsor sends
    invites over ITS service TL context; both sides resolving the same
    first-service-capable TL is the (documented) symmetry assumption."""
    order = sorted(
        context.tl_contexts.items(),
        key=lambda kv: (not kv[1].tl_lib.tl_cls.SERVICE_CAPABLE,
                        -kv[1].tl_lib.tl_cls.DEFAULT_SCORE))
    for _name, handle in order:
        if not handle.tl_lib.tl_cls.SERVICE_CAPABLE:
            continue
        obj = handle.obj
        if getattr(obj, "transport", None) is not None and \
                hasattr(obj, "send_to"):
            return obj
    return None


class GrowRequest:
    """Nonblocking team-grow state machine: AGREE (admit proposal rides
    FtAgreement) -> INVITE (sponsor sends join tickets) -> REBUILD
    (survivors + joiners bootstrap the successor over TransportOob) ->
    RETIRE+FENCE (success only). The old team is retired and fenced
    ONLY after the successor is ACTIVE — a joiner dying mid-bootstrap
    rolls back to a fully usable old team and fails the grow with
    ``ERR_TIMED_OUT`` naming the absent joiner(s)
    (``absent_joiners``)."""

    def __init__(self, team: Team, new_ctx_ranks: Iterable[int],
                 timeout_s: Optional[float] = None):
        if team.state != TeamState.ACTIVE:
            raise UccError(Status.ERR_INVALID_PARAM,
                           "grow of a non-active team")
        if team._shrunk:
            raise UccError(Status.ERR_INVALID_PARAM,
                           "grow of a retired team; use the successor")
        svc = team.service_team
        if svc is None or getattr(svc, "transport", None) is None:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           "grow requires a transport-backed service team")
        admit = sorted({int(r) for r in new_ctx_ranks})
        if not admit:
            raise UccError(Status.ERR_INVALID_PARAM,
                           "grow needs at least one joiner ctx rank")
        members = {int(team.ctx_map.eval(i)) for i in range(team.size)}
        overlap = sorted(set(admit) & members)
        if overlap:
            raise UccError(
                Status.ERR_INVALID_PARAM,
                f"ctx rank(s) {overlap} are already team members")
        self.team = team
        self.status = Status.IN_PROGRESS
        self.new_team: Optional[Team] = None
        self.failed_ranks: Optional[List[int]] = None
        self.absent_joiners: Optional[List[int]] = None
        self.epoch: Optional[int] = None
        self._proposed = admit
        self._admit: List[int] = []
        self._attempt = team._grow_attempts
        team._grow_attempts = self._attempt + 1
        self._deadline = time.monotonic() + (
            timeout_s if timeout_s is not None else _grow_timeout())
        self._ack_reqs: Dict[int, Any] = {}
        self._ack_bufs: Dict[int, np.ndarray] = {}
        self._acked: Set[int] = set()
        ctx = team.context
        # local dead view from health attribution only (no hint — a grow
        # is not how an operator names dead ranks): the agreement folds
        # concurrent deaths into the same membership change
        local_dead: Set[int] = set()
        reg = getattr(ctx, "health", None)
        if reg is not None:
            dead_ctx = reg.dead_set()
            for i in range(team.size):
                if int(team.ctx_map.eval(i)) in dead_ctx:
                    local_dead.add(i)
        local_dead.discard(team.rank)
        from ..fault.agree import FtAgreement
        # kind carries the attempt counter: a retried grow's agreement
        # must never cross-match leftover rounds of an aborted attempt
        self._agree = FtAgreement(team.service_team, local_dead,
                                  team.epoch, proposal=admit,
                                  kind=f"grow:{self._attempt}")
        self._agree.progress_queue = ctx.progress_queue
        self._agree.post()
        self._state = "agree"

    def test(self) -> Status:
        if self.status != Status.IN_PROGRESS:
            return self.status
        try:
            return self._step()
        except UccError as e:
            logger.error("team grow failed: %s", e)
            self._rollback(e.status)
            return self.status

    # ------------------------------------------------------------------
    def _rollback(self, status: Status, reason: str = "") -> None:
        """Abandon the grow, leaving the OLD team fully usable: the
        half-created successor (if any) is failed and destroyed,
        outstanding joiner-ack recvs are
        withdrawn, and the old team was never retired or fenced."""
        for rq in self._ack_reqs.values():
            try:
                rq.cancel()
            except Exception:  # noqa: BLE001 - teardown must continue
                pass
        self._ack_reqs.clear()
        nt, self.new_team = self.new_team, None
        if nt is not None:
            nt.fail(status, reason or "grow rolled back")
            nt.destroy()
        self.status = status

    def _step(self) -> Status:
        team = self.team
        if self._state == "agree":
            a = self._agree
            if not a.is_completed():
                if time.monotonic() > self._deadline:
                    a.cancel(Status.ERR_TIMED_OUT)
                    raise UccError(Status.ERR_TIMED_OUT,
                                   "grow agreement timed out")
                return Status.IN_PROGRESS
            if a.super_status.is_error:
                self._rollback(a.super_status, "grow agreement failed")
                return self.status
            dead = a.result_dead or set()
            admit = sorted(a.result_admit or ())
            self.epoch = a.result_epoch
            self.failed_ranks = sorted(dead)
            if team.rank in dead:
                # the agreement excluded THIS rank (mid-grow death race
                # lost): bounded outcome, re-admission via Team.join
                raise UccError(
                    Status.ERR_RANK_FAILED,
                    "this rank was excluded by the grow agreement")
            reg = getattr(team.context, "health", None)
            if reg is not None:
                for tr in dead:
                    reg.report_failure(int(team.ctx_map.eval(tr)),
                                       "agreement",
                                       f"agreed dead in team {team.id} "
                                       f"grow to epoch {self.epoch}")
                # re-admission: an admitted ctx this registry had
                # condemned (false suspicion, past kill drill) is
                # revived BEFORE the rebuild, or the new service team's
                # fail-fast path would refuse to post to it
                for c in admit:
                    reg.revive(c, "grow",
                               f"admitted into team {team.id} "
                               f"epoch {self.epoch}")
            survivors = [i for i in range(team.size) if i not in dead]
            self._admit = admit
            space = ("grow", team.team_key, self.epoch, self._attempt)
            sponsor = survivors[0]
            if team.rank == sponsor:
                self._send_invites(space, survivors, admit)
            logger.warning(
                "team %s growing: admitting ctx rank(s) %s (dead %s, "
                "%d survivors), epoch %d", team.id, admit,
                self.failed_ranks, len(survivors), self.epoch)
            self.new_team = Team.create_from_parent(
                team, survivors, dead=sorted(dead), epoch=self.epoch,
                admit_ctx=admit, attempt=self._attempt)
            # joiner-liveness acks: one recv per joiner in the grow tag
            # space, so a rebuild stuck on an absent joiner is
            # attributable by name at the deadline
            tr = team.service_team.transport
            for c in admit:
                buf = np.zeros(1, dtype=np.int64)
                self._ack_bufs[c] = buf
                self._ack_reqs[c] = tr.recv_nb(
                    _grow_ack_key(space, self.epoch, c), buf)
            self._state = "rebuild"
        if self._state == "rebuild":
            assert self.new_team is not None
            for c, rq in list(self._ack_reqs.items()):
                if rq.test():
                    self._acked.add(c)
                    del self._ack_reqs[c]
            st = self.new_team.create_test()
            if st == Status.IN_PROGRESS:
                if time.monotonic() > self._deadline:
                    absent = sorted(set(self._admit) - self._acked)
                    self.absent_joiners = absent
                    msg = (f"grow of team {team.id} to epoch "
                           f"{self.epoch} timed out; absent joiner ctx "
                           f"rank(s): {absent or 'none (bootstrap hang)'}")
                    self._rollback(Status.ERR_TIMED_OUT, msg)
                    logger.error("%s — old team stays usable", msg)
                    return self.status
                return st
            if st.is_error:
                self._rollback(st, "successor create failed")
                return self.status
            # SUCCESS — only now does the old epoch retire: cancel the
            # stragglers still in flight on it (bounded ERR_CANCELED,
            # they had all of agree+rebuild to finish), fence its tag
            # spaces so no pre-grow send can land in a post-grow lease,
            # and hand telemetry state to the successor
            for rq in self._ack_reqs.values():
                rq.cancel()
            self._ack_reqs.clear()
            team._shrunk = True
            team._retired_by = "grow"
            self._cancel_old_in_flight()
            team._fence(self.epoch)
            fr = team.context.flight
            if fr is not None:
                fr.membership(team.id, self.epoch, "grow",
                              f"admit={self._admit}")
            if metrics.ENABLED:
                metrics.inc("team_grows", component="core")
            _collector_handoff(team, self.new_team)
            self._state = "done"
            self.status = Status.OK
        return self.status

    def _send_invites(self, space, survivors: List[int],
                      admit: List[int]) -> None:
        """Sponsor (lowest surviving rank) sends each joiner its ticket:
        everything a context needs to bootstrap into the successor with
        no parent handle — the bootstrap space, epoch, agreed member
        order, and the survivor ctx set to ack."""
        team = self.team
        survivor_ctx = [int(team.ctx_map.eval(r)) for r in survivors]
        ticket = {
            "space": space,
            "epoch": int(self.epoch),
            "members": survivor_ctx + list(admit),
            "survivors": survivor_ctx,
            "team": team.id,
        }
        blob = np.frombuffer(pickle.dumps(ticket), dtype=np.uint8).copy()
        comp = team.service_team.comp_context
        for c in admit:
            comp.send_to(c, _join_invite_key(c, 0),
                         np.array([blob.size], dtype=np.int64))
            comp.send_to(c, _join_invite_key(c, 1), blob)

    def _cancel_old_in_flight(self) -> None:
        """Bound collectives still riding the retired epoch with
        ``ERR_CANCELED`` (no rank failed — membership changed under
        them; recovery traffic is exempt as everywhere else)."""
        if self.team.coalescer is not None:
            # batch-held members never reached the progress queue
            self.team.coalescer.abort(Status.ERR_CANCELED)
        queue = self.team.context.progress_queue
        n = 0
        for task in list(getattr(queue, "_q", ())):
            if task.is_completed() or getattr(task, "_ft_exempt", False):
                continue
            core = getattr(task.team, "core_team", task.team)
            if core is not self.team:
                continue
            task.cancel(Status.ERR_CANCELED)
            n += 1
        if n:
            logger.warning(
                "team %s grow: cancelled %d in-flight task(s) on the "
                "retired epoch", self.team.id, n)


class JoinRequest:
    """Nonblocking joiner-side bootstrap: INVITE (recv the sponsor's
    ticket on this context's well-known join key) -> REBUILD (enter the
    grow TransportOob space and drive the successor team's create) ->
    OK. Symmetric rollback: a deadline expiry fails + destroys the
    half-created team and times out with ``ERR_TIMED_OUT``."""

    def __init__(self, context: Context,
                 timeout_s: Optional[float] = None):
        self.context = context
        self.status = Status.IN_PROGRESS
        self.new_team: Optional[Team] = None
        self.epoch: Optional[int] = None
        ep = _service_endpoint(context)
        if ep is None:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           "join requires a transport-backed service-"
                           "capable TL context")
        self._ep = ep
        self._transport = ep.transport
        self._deadline = time.monotonic() + (
            timeout_s if timeout_s is not None else _grow_timeout())
        self._size_req = None
        self._size_buf: Optional[np.ndarray] = None
        self._payload_req = None
        self._payload_buf: Optional[np.ndarray] = None
        self._post_size_recv()
        self._state = "invite"

    def _post_size_recv(self) -> None:
        self._size_buf = np.full(1, -1, dtype=np.int64)
        self._size_req = self._transport.recv_nb(
            _join_invite_key(self.context.rank, 0), self._size_buf)

    def _poll_invite(self):
        """Nonblocking invite poll: returns a decoded ticket when a full
        (size, payload) pair has arrived, else None. The recv stays
        posted ACROSS the bootstrap too: an invite parked from an
        aborted earlier grow attempt is indistinguishable from the live
        one at consume time, so instead of guessing, the joiner treats
        every LATER-arriving invite as superseding the bootstrap in
        progress — the dead attempt's space can never complete, the live
        sponsor's invite always arrives after it."""
        if self._size_req is not None and self._size_req.test():
            self._size_req = None
            n = int(self._size_buf[0])
            if n <= 0:
                raise UccError(Status.ERR_INVALID_PARAM,
                               "malformed grow invite (empty)")
            self._payload_buf = np.zeros(n, dtype=np.uint8)
            self._payload_req = self._transport.recv_nb(
                _join_invite_key(self.context.rank, 1), self._payload_buf)
        if self._payload_req is not None and self._payload_req.test():
            self._payload_req = None
            return pickle.loads(self._payload_buf.tobytes())
        return None

    def test(self) -> Status:
        if self.status != Status.IN_PROGRESS:
            return self.status
        try:
            return self._step()
        except UccError as e:
            logger.error("team join failed: %s", e)
            self._rollback(e.status)
            return self.status

    def _rollback(self, status: Status) -> None:
        for rq in (self._size_req, self._payload_req):
            if rq is not None:
                try:
                    rq.cancel()
                except Exception:  # noqa: BLE001 - teardown must continue
                    pass
        self._size_req = self._payload_req = None
        nt, self.new_team = self.new_team, None
        if nt is not None:
            nt.fail(status, "join rolled back")
            nt.destroy()
        self.status = status

    def _expired(self) -> bool:
        return time.monotonic() > self._deadline

    def _step(self) -> Status:
        if self._state == "invite":
            ticket = self._poll_invite()
            if ticket is None:
                if self._expired():
                    raise UccError(Status.ERR_TIMED_OUT,
                                   "join timed out waiting for a grow "
                                   "invite")
                return Status.IN_PROGRESS
            self._enter(ticket)
            # keep listening: a NEWER invite supersedes this bootstrap
            # (this one may be a stale leftover of an aborted attempt)
            self._post_size_recv()
            self._state = "rebuild"
        if self._state == "rebuild":
            ticket = self._poll_invite()
            if ticket is not None:
                nt, self.new_team = self.new_team, None
                if nt is not None:
                    nt.fail(Status.ERR_CANCELED,
                            "superseded by a newer grow invite")
                    nt.destroy()
                logger.warning("ctx rank %d join: switching to a newer "
                               "grow invite", self.context.rank)
                self._enter(ticket)
                self._post_size_recv()
            if self.new_team is None:
                # mid-switch: waiting for the newer invite's payload
                if self._expired():
                    raise UccError(Status.ERR_TIMED_OUT,
                                   "join timed out mid-invite")
                return Status.IN_PROGRESS
            st = self.new_team.create_test()
            if st == Status.IN_PROGRESS:
                if self._expired():
                    raise UccError(Status.ERR_TIMED_OUT,
                                   "join bootstrap timed out")
                return st
            if st.is_error:
                self._rollback(st)
                return self.status
            # success: withdraw the supersede listener — a parked invite
            # beyond this one belongs to the NEXT join
            for rq in (self._size_req, self._payload_req):
                if rq is not None:
                    rq.cancel()
            self._size_req = self._payload_req = None
            self._state = "done"
            self.status = Status.OK
        return self.status

    def _enter(self, ticket: Dict[str, Any]) -> None:
        """Consume the invite: revive every member in the local health
        registry (this context may have condemned survivors — or itself,
        after a kill drill — while it was out), ack every survivor (the
        liveness signal the grow's absent-joiner attribution reads), and
        enter the bootstrap space."""
        space = ticket["space"]
        ep_num = int(ticket["epoch"])
        members = [int(c) for c in ticket["members"]]
        if self.context.rank not in members:
            raise UccError(Status.ERR_INVALID_PARAM,
                           "grow invite does not include this context")
        self.epoch = ep_num
        reg = getattr(self.context, "health", None)
        if reg is not None:
            for c in members:
                reg.revive(c, "join",
                           f"joining team {ticket.get('team')} "
                           f"epoch {ep_num}")
        ack = np.ones(1, dtype=np.int64)
        for s in ticket["survivors"]:
            self._ep.send_to(int(s),
                             _grow_ack_key(space, ep_num,
                                           self.context.rank), ack)
        from .oob import TransportOob
        oob = TransportOob(self._ep, self._transport, members,
                           self.context.rank, space, ep_num)
        fr = self.context.flight
        if fr is not None:
            fr.membership(ticket.get("team"), ep_num, "join",
                          f"members={len(members)}")
        logger.warning("ctx rank %d joining team (epoch %d, %d members)",
                       self.context.rank, ep_num, len(members))
        self.new_team = Team(self.context, TeamParams(oob=oob,
                                                      epoch=ep_num))
