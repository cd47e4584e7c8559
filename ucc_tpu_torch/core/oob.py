"""In-process OOB bootstrap collective.

UCC takes OOB as a user callback (ucc_oob_coll_t); its test harness
implements it with threads + memcpy inside one process. ThreadOobWorld is
that harness: N in-process endpoints sharing a lock-protected round
buffer, used by tests and by single-process multi-context jobs (the ranks
of one GPU).
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
    """Shared state for N in-process OOB endpoints."""

    def __init__(self, n: int):
        self.n = n
        self.lock = threading.Lock()
        self.rounds: Dict[int, _ThreadRound] = {}
        self.next_round = [0] * n  # per-endpoint round cursor

    def endpoint(self, rank: int) -> "ThreadOob":
        return ThreadOob(self, rank)

    def endpoints(self) -> List["ThreadOob"]:
        return [self.endpoint(r) for r in range(self.n)]


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


class ThreadOob(OobColl):
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
