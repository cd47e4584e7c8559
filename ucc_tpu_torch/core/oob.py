"""In-process OOB bootstrap collective.

UCC takes OOB as a user callback (ucc_oob_coll_t); its test harness
implements it with threads + memcpy inside one process. ThreadOobWorld is
that harness: N in-process endpoints sharing a lock-protected round
buffer, used by tests and by single-process multi-context jobs (the ranks
of one GPU). ``SubsetOob`` restricts an OOB to a subset of its ranks, for
teams split from a parent (``Team.create_from_parent``).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ..api.types import OobColl, OobRequest
from ..status import Status


class _ThreadRound:
    def __init__(self, n: int):
        self.contribs: List[Optional[bytes]] = [None] * n
        self.n_arrived = 0
        self.consumed = [False] * n


class ThreadOobWorld:
    """Shared state for N in-process OOB endpoints.

    Besides the whole-world rounds, the world keeps a round space per
    subset of ranks, so a ``SubsetOob`` over a thread endpoint exchanges
    among its members only: non-members never contribute."""

    def __init__(self, n: int):
        self.n = n
        self.lock = threading.Lock()
        self.rounds: Dict[int, _ThreadRound] = {}
        self.next_round = [0] * n  # per-endpoint round cursor
        #: per-subset round spaces: {(ranks, idx): round}, with a cursor
        #: per (subset, member)
        self.sub_rounds: Dict[tuple, _ThreadRound] = {}
        self.sub_next: Dict[tuple, int] = {}

    def endpoint(self, rank: int) -> "ThreadOob":
        return ThreadOob(self, rank)

    def endpoints(self) -> List["ThreadOob"]:
        return [self.endpoint(r) for r in range(self.n)]

    def subset_allgather(self, rank: int, ranks: tuple,
                         data: bytes) -> OobRequest:
        if rank not in ranks:
            raise ValueError("subset allgather from a non-member")
        my = ranks.index(rank)
        with self.lock:
            cur = (ranks, rank)
            idx = self.sub_next.get(cur, 0)
            self.sub_next[cur] = idx + 1
            key = (ranks, idx)
            rnd = self.sub_rounds.get(key)
            if rnd is None:
                rnd = self.sub_rounds[key] = _ThreadRound(len(ranks))
            rnd.contribs[my] = bytes(data)
            rnd.n_arrived += 1
        return _ThreadSubsetRequest(self, key, my)


class _CompletedOobRequest(OobRequest):
    """An already satisfied request: what a non-member gets back from
    ``SubsetOob.participate`` over a subset-capable parent."""

    def __init__(self, result: List[bytes]):
        self._result = result

    def test(self) -> Status:
        return Status.OK

    @property
    def result(self) -> List[bytes]:
        return self._result


class _ThreadOobRequest(OobRequest):
    def __init__(self, world: ThreadOobWorld, round_idx: int, rank: int):
        self.world = world
        self.round_idx = round_idx
        self.rank = rank
        self._cached: Optional[List[bytes]] = None

    def test(self) -> Status:
        with self.world.lock:
            rnd = self.world.rounds.get(self.round_idx)
            if rnd is None:
                return Status.OK  # already consumed+GC'd via result
            if rnd.n_arrived == self.world.n:
                return Status.OK
        return Status.IN_PROGRESS

    @property
    def result(self) -> List[bytes]:
        if self._cached is not None:
            return self._cached
        with self.world.lock:
            rnd = self.world.rounds[self.round_idx]
            self._cached = list(rnd.contribs)  # type: ignore[arg-type]
            rnd.consumed[self.rank] = True
            # GC only when every endpoint has read this round's result
            if all(rnd.consumed) and rnd.n_arrived == self.world.n:
                self.world.rounds.pop(self.round_idx, None)
        return self._cached


class _ThreadSubsetRequest(OobRequest):
    """The subset-space twin of :class:`_ThreadOobRequest` (keyed by
    ``(ranks, idx)`` in ``world.sub_rounds``, indexed by member)."""

    def __init__(self, world: ThreadOobWorld, key: tuple, member: int):
        self.world = world
        self.key = key
        self.member = member
        self._n = len(key[0])
        self._cached: Optional[List[bytes]] = None

    def test(self) -> Status:
        with self.world.lock:
            rnd = self.world.sub_rounds.get(self.key)
            if rnd is None:
                return Status.OK  # consumed + GC'd via result
            if rnd.n_arrived == self._n:
                return Status.OK
        return Status.IN_PROGRESS

    @property
    def result(self) -> List[bytes]:
        if self._cached is not None:
            return self._cached
        with self.world.lock:
            rnd = self.world.sub_rounds[self.key]
            self._cached = list(rnd.contribs)  # type: ignore[arg-type]
            rnd.consumed[self.member] = True
            if all(rnd.consumed) and rnd.n_arrived == self._n:
                self.world.sub_rounds.pop(self.key, None)
        return self._cached


class ThreadOob(OobColl):
    #: a SubsetOob over this endpoint runs members-only rounds (see
    #: ThreadOobWorld.subset_allgather); non-members need not participate
    SUBSET_CAPABLE = True

    def __init__(self, world: ThreadOobWorld, rank: int):
        self.world = world
        self.rank = rank

    @property
    def oob_ep(self) -> int:
        return self.rank

    @property
    def n_oob_eps(self) -> int:
        return self.world.n

    def allgather(self, data: bytes) -> OobRequest:
        w = self.world
        with w.lock:
            idx = w.next_round[self.rank]
            w.next_round[self.rank] += 1
            rnd = w.rounds.get(idx)
            if rnd is None:
                rnd = w.rounds[idx] = _ThreadRound(w.n)
            rnd.contribs[self.rank] = bytes(data)
            rnd.n_arrived += 1
        return _ThreadOobRequest(w, idx, self.rank)

    def subset_allgather(self, data: bytes, ranks) -> OobRequest:
        return self.world.subset_allgather(
            self.rank, tuple(int(r) for r in ranks), bytes(data))


class SubsetOob(OobColl):
    """A team-level OOB made of a parent OOB restricted to a subset of its
    ranks (UCC's gtest harness: UccTeam::allgather).

    When the parent advertises ``SUBSET_CAPABLE`` (thread OOB endpoints,
    and SubsetOobs stacked on one), subset rounds run among the members
    only: non-members never participate, and a nested subgroup costs no
    whole-team round at any level.

    Over a parent that is not capable, every allgather rides a full
    parent round, so every non-member must call
    ``SubsetOob.participate(parent)`` once per subset round, or the
    members' requests never complete. ``Team.create_from_parent`` keeps
    whichever contract the parent has."""

    def __init__(self, parent: OobColl, ranks: List[int]):
        self.parent = parent
        self.ranks = list(ranks)
        if parent.oob_ep not in self.ranks:
            raise ValueError("SubsetOob endpoint not in subset")
        self.my = self.ranks.index(parent.oob_ep)
        self._direct = bool(getattr(parent, "SUBSET_CAPABLE", False)) and \
            callable(getattr(parent, "subset_allgather", None))

    @property
    def SUBSET_CAPABLE(self) -> bool:   # noqa: N802 - capability flag
        return self._direct             # nested subsets inherit it

    @staticmethod
    def participate(parent: OobColl) -> OobRequest:
        """A non-member's contribution to one subset round (an empty
        payload); a no-op on a subset-capable parent."""
        if getattr(parent, "SUBSET_CAPABLE", False):
            return _CompletedOobRequest([])
        return parent.allgather(b"")

    @property
    def oob_ep(self) -> int:
        return self.my

    @property
    def n_oob_eps(self) -> int:
        return len(self.ranks)

    def allgather(self, data: bytes) -> OobRequest:
        if self._direct:
            return self.parent.subset_allgather(data, self.ranks)
        inner = self.parent.allgather(data)
        return _SubsetOobRequest(inner, self.ranks)

    def subset_allgather(self, data: bytes, ranks) -> OobRequest:
        """A nested subset round: member indices translated to parent
        ranks, on the parent's subset space."""
        if not self._direct:
            raise ValueError("subset_allgather over a parent that is not "
                             "subset-capable")
        return self.parent.subset_allgather(
            data, [self.ranks[int(r)] for r in ranks])


class _SubsetOobRequest(OobRequest):
    def __init__(self, inner: OobRequest, ranks: List[int]):
        self.inner = inner
        self.ranks = ranks

    def test(self) -> Status:
        return self.inner.test()

    @property
    def result(self) -> List[bytes]:
        full = self.inner.result
        return [full[r] for r in self.ranks]
