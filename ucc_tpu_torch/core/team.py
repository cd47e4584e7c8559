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
"""
from __future__ import annotations

import enum
import os
import pickle
from typing import Any, List, Optional

import numpy as np

from ..api.types import OobRequest, TeamAttr, TeamParams
from ..constants import ReductionOp
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

    _destroyed = False
    #: online tuner (score/tuner.OnlineTuner), attached at activation when
    #: UCC_TUNER=online; None (class attr, no cost) otherwise — dispatch
    #: reads it once per collective INIT
    tuner = None

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
        self.state = TeamState.ADDR_EXCHANGE
        #: QoS priority class (progress-queue lane): explicit create param
        #: wins, else the UCC_TEAM_PRIORITY env, else the middle class
        from ..schedule.progress import DEFAULT_PRIORITY, clamp_priority
        pr = getattr(p, "priority", None)
        if pr is None:
            pr = os.environ.get("UCC_TEAM_PRIORITY", DEFAULT_PRIORITY)
        self.priority = clamp_priority(pr)
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
    def _start_state_machine(self) -> None:
        if self.oob is not None:
            # exchange (ctx_rank, leader_counter, leader pid)
            leader_counter = -1
            if self.rank == 0:
                leader_counter = self.context._team_id_counter
                self.context._team_id_counter += 1
            payload = pickle.dumps((self.context.rank, leader_counter,
                                    self.context.proc[1]))
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
                self.team_key = (tuple(int(e[0]) for e in entries),
                                 leader[1], leader[2])
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
        the service team and the CL teams' TL teams (an epoch fence must
        cover them all; perftest names the transport tier from them)."""
        spaces = []

        def visit(t):
            if t is None:
                return
            tk = getattr(t, "team_key", None)
            tr = getattr(t, "transport", None)
            if tk is not None and tr is not None and hasattr(tr, "fence"):
                spaces.append((tk, tr))
            for sub in getattr(t, "tl_teams", ()) or ():
                visit(sub)
            for sub in getattr(t, "_pending", ()) or ():
                visit(sub)

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
                           admit_ctx: Optional[List[int]] = None
                           ) -> Optional["Team"]:
        """ucc_team_create_from_parent: split `parent` by explicit
        parent-team `ranks` (that order is the new team's). Every parent
        rank calls it; non-members get None. The new team is posted: drive
        its ``create_test()`` as any team's.

        Over a subset-capable parent OOB (a thread OOB, or a team split
        from one) non-members skip the subset's rounds entirely; over any
        other they ride along once per round (``SubsetOob.participate``).
        The rebuilds of fault tolerance (`dead`, `admit_ctx`) are not
        ported yet."""
        if dead or admit_ctx:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           "create_from_parent with dead or admitted ranks "
                           "(the shrink and grow rebuilds) is not ported "
                           "yet")
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
            self.service_team.destroy()
        return Status.OK
