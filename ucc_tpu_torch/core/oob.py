"""OOB bootstrap collectives.

UCC takes OOB as a user callback (ucc_oob_coll_t); its test harness
implements it with threads + memcpy inside one process. ThreadOobWorld is
that harness: N in-process endpoints sharing a lock-protected round
buffer, used by tests and by single-process multi-context jobs (the ranks
of one GPU). ``SubsetOob`` restricts an OOB to a subset of its ranks, for
teams split from a parent (``Team.create_from_parent``).

Across processes, ``TcpStoreOob`` rendezvouses through a small TCP
allgather server hosted by rank 0 (a per-job cookie handshake, crc32 on
every frame, connect backoff and a bootstrap deadline). ``TcpTreeOob``
and ``ThreadTreeOobWorld`` run the same ordered allgather as a tree of
small group stores, so no store serves more than max(ppn, radix)
members. ``TransportOob`` exchanges over a TL transport among a chosen
set of context ranks, without the parent OOB.
"""
from __future__ import annotations

import os
import pickle
import random
import selectors
import socket
import struct
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

from ..api.types import OobColl, OobRequest
from ..obs import metrics
from ..status import Status, UccError
from ..utils.log import get_logger

logger = get_logger("oob")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


#: client connect backoff: exponential with full jitter, bounded by the
#: caller's deadline, so restarted clients do not retry in lockstep
CONNECT_BACKOFF_BASE = _env_float("UCC_OOB_CONNECT_BACKOFF_BASE", 0.05)
CONNECT_BACKOFF_MAX = _env_float("UCC_OOB_CONNECT_BACKOFF_MAX", 2.0)
#: how long the store server waits for every rank to register before it
#: fails the registered ones with ERR_TIMED_OUT naming the absentees
#: (0 or negative: wait forever)
BOOTSTRAP_TIMEOUT = _env_float("UCC_OOB_BOOTSTRAP_TIMEOUT", 120.0)


def _knob(name: str, default: str) -> str:
    """A bootstrap knob: the environment, then UCC_CONFIG_FILE, then the
    default (the OOB runs before any Lib config object exists)."""
    if name in os.environ:
        return os.environ[name]
    cfg_file = os.environ.get("UCC_CONFIG_FILE", "")
    if cfg_file:
        try:
            from ..utils.config import load_config_file
            vals = load_config_file(cfg_file)
            if name in vals:
                return vals[name]
        except Exception:  # noqa: BLE001 - malformed file: use default
            pass
    return default


def _knob_int(name: str, default: int) -> int:
    try:
        return int(_knob(name, "") or default)
    except ValueError:
        return default


def tree_radix() -> int:
    """Upper-level fan-in of the tree bootstrap (``UCC_OOB_TREE_RADIX``,
    default 8, at least 2): node leaders are grouped into parent stores
    of at most this many members per level."""
    return max(2, _knob_int("UCC_OOB_TREE_RADIX", 8))


def tree_thresh() -> int:
    """``UCC_OOB_TREE=auto`` takes the tree once the job has at least
    this many ranks (``UCC_OOB_TREE_THRESH``, default 32)."""
    return max(2, _knob_int("UCC_OOB_TREE_THRESH", 32))


def tree_mode_enabled(n_ranks: int, host: Optional[str] = None) -> bool:
    """Resolve ``UCC_OOB_TREE`` (a bool, ``auto`` or ``tree``) for a job
    of *n_ranks* whose stores would bind on *host*. ``auto`` takes the
    tree only for a loopback coordinator (every group store binds on the
    coordinator's host) and at least ``tree_thresh()`` ranks."""
    raw = _knob("UCC_OOB_TREE", "auto").strip().lower()
    local = host is None or host in ("127.0.0.1", "localhost", "::1")
    if raw in ("auto", ""):
        return local and n_ranks >= tree_thresh()
    if raw == "tree":
        return True
    try:
        from ..utils.config import parse_bool
        return parse_bool(raw)
    except ValueError:
        logger.warning("unrecognized UCC_OOB_TREE=%r; treating as auto",
                       raw)
        return local and n_ranks >= tree_thresh()


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


# ---------------------------------------------------------------------------
# OOB over a TL transport
# ---------------------------------------------------------------------------

class TransportOob(OobColl):
    """OOB allgather over a TL transport among a set of context ranks,
    without the parent OOB: the members exchange blobs point to point
    under a ``("ftoob", space_key)`` tag space keyed by *epoch*, so a team
    can bootstrap from its live members when the parent OOB has members
    that will never contribute. Calls are issued in the same order on
    every member (the UCC OOB contract); each consumes one round."""

    def __init__(self, comp_context, transport, member_ctx_ranks, my_ctx,
                 space_key, epoch: int):
        self.comp_context = comp_context
        self.transport = transport
        self.members = [int(r) for r in member_ctx_ranks]
        if int(my_ctx) not in self.members:
            raise ValueError("TransportOob endpoint not in member set")
        self.my_ctx = int(my_ctx)
        self.my = self.members.index(self.my_ctx)
        #: tag-space root, distinct from every team's key (epoch at
        #: key[1], as the fences expect)
        self.team_key = ("ftoob", space_key)
        self.epoch = int(epoch)
        self._round = 0

    @property
    def oob_ep(self) -> int:
        return self.my

    @property
    def n_oob_eps(self) -> int:
        return len(self.members)

    def _key(self, round_idx: int, phase: int, src_ctx: int):
        return (self.team_key, self.epoch, round_idx, phase, src_ctx)

    def allgather(self, data: bytes) -> OobRequest:
        r = self._round
        self._round += 1
        return _TransportOobRequest(self, r, bytes(data))


class _TransportOobRequest(OobRequest):
    """Radix-``tree_radix()`` tree gather then bcast, rooted at member 0:
    each member merges its children's subtree blobs and forwards one blob
    to its parent; the root's assembled result comes back down the same
    tree. Every recv of both phases is posted at construction; leaves
    send at construction. Phases: 0 gather size, 1 gather payload, 2
    bcast size, 3 bcast payload.

    Interior members merge and forward inside ``test``, so every
    member's request must be polled."""

    def __init__(self, oob: TransportOob, round_idx: int, data: bytes):
        import numpy as np
        self.oob = oob
        self.round_idx = round_idx
        self.data = data
        self._np = np
        n = oob.n_oob_eps
        k = tree_radix()
        me = oob.my
        self.children = [c for c in range(k * me + 1, k * me + k + 1)
                         if c < n]
        self.parent = (me - 1) // k if me else None
        self._result: Optional[List[bytes]] = None
        self._sent_up = False
        self._gsz = {c: np.zeros(1, dtype=np.int64) for c in self.children}
        self._gszreq = {c: oob.transport.recv_nb(
            oob._key(round_idx, 0, oob.members[c]), self._gsz[c])
            for c in self.children}
        self._gpay: Dict[int, Any] = {}
        self._gpayreq: Dict[int, Any] = {}
        self._sub: Dict[int, dict] = {}   # child -> its subtree blobs
        self._bsz = None
        self._bszreq = None
        self._bpay = None
        self._bpayreq = None
        if self.parent is not None:
            self._bsz = np.zeros(1, dtype=np.int64)
            self._bszreq = oob.transport.recv_nb(
                oob._key(round_idx, 2, oob.members[self.parent]), self._bsz)
        if not self.children:
            self._send_up()

    def _send_up(self) -> None:
        agg: Dict[int, bytes] = {self.oob.my: self.data}
        for part in self._sub.values():
            agg.update(part)
        self._sent_up = True
        if self.parent is None:
            self._finish(agg)              # root: assemble and fan out
        else:
            self._send_blob(self.parent, 0, pickle.dumps(agg))

    def _check(self, rq, what: str, member: int) -> bool:
        if not rq.test():
            return False
        if getattr(rq, "error", None):
            raise UccError(Status.ERR_NO_MESSAGE,
                           f"transport OOB {what} recv from member "
                           f"{member} failed: {rq.error}")
        return True

    def _send_blob(self, member: int, phase: int, blob: bytes) -> None:
        np = self._np
        oob = self.oob
        oob.comp_context.send_to(
            oob.members[member], oob._key(self.round_idx, phase, oob.my_ctx),
            np.array([len(blob)], dtype=np.int64))
        oob.comp_context.send_to(
            oob.members[member],
            oob._key(self.round_idx, phase + 1, oob.my_ctx),
            np.frombuffer(blob, dtype=np.uint8))

    def _finish(self, full: Dict[int, bytes]) -> None:
        if self.children:
            blob = pickle.dumps(full)
            for c in self.children:
                self._send_blob(c, 2, blob)
        self._result = [full[i] for i in range(self.oob.n_oob_eps)]

    def test(self) -> Status:
        if self._result is not None:
            return Status.OK
        oob = self.oob
        np = self._np
        oob.transport.progress()
        for c, rq in list(self._gszreq.items()):
            if not self._check(rq, "gather size", c):
                continue
            del self._gszreq[c]
            buf = np.zeros(max(1, int(self._gsz[c][0])), dtype=np.uint8)
            self._gpay[c] = buf
            self._gpayreq[c] = oob.transport.recv_nb(
                oob._key(self.round_idx, 1, oob.members[c]), buf)
        for c, rq in list(self._gpayreq.items()):
            if not self._check(rq, "gather payload", c):
                continue
            del self._gpayreq[c]
            self._sub[c] = pickle.loads(
                self._gpay.pop(c)[:int(self._gsz[c][0])].tobytes())
        if not self._sent_up and not self._gszreq and not self._gpayreq:
            self._send_up()
            if self._result is not None:   # childless root (n == 1)
                return Status.OK
        if self._bszreq is not None and self._bpayreq is None and \
                self._check(self._bszreq, "bcast size", self.parent):
            self._bpay = np.zeros(max(1, int(self._bsz[0])), dtype=np.uint8)
            self._bpayreq = oob.transport.recv_nb(
                oob._key(self.round_idx, 3, oob.members[self.parent]),
                self._bpay)
        if self._bpayreq is not None and \
                self._check(self._bpayreq, "bcast payload", self.parent):
            full = pickle.loads(self._bpay[:int(self._bsz[0])].tobytes())
            self._bpayreq = None
            self._bszreq = None
            self._finish(full)
            return Status.OK
        return Status.IN_PROGRESS

    @property
    def result(self) -> List[bytes]:
        if self._result is None:
            self.wait()
        assert self._result is not None
        return self._result


# ---------------------------------------------------------------------------
# tree-structured OOB
# ---------------------------------------------------------------------------

def parse_node_sizes(spec) -> Optional[List[int]]:
    """Ranks-per-node spec: an int, a list of ints, or a string: one int
    N (nodes of N) or a comma list applied cyclically (``"2,1,3"``)."""
    if spec is None:
        return None
    if isinstance(spec, int):
        return [max(1, spec)]
    if isinstance(spec, (list, tuple)):
        out = [max(1, int(s)) for s in spec]
        return out or None
    try:
        out = [max(1, int(tok)) for tok in str(spec).split(",")
               if tok.strip()]
    except ValueError:
        return None
    return out or None


def tree_layout(size: int, ppn=None,
                radix: Optional[int] = None) -> List[List[List[int]]]:
    """Bootstrap tree over ``size`` ranks: ``levels[l]`` partitions that
    level's participants into groups (lists of world ranks). Level 0
    groups contiguous rank blocks into nodes (cyclic over the *ppn*
    sizes; *radix*-sized blocks when no node shape is given); each higher
    level groups the previous level's leaders (``group[0]``) into chunks
    of at most *radix*, until one top group remains. A pure function of
    its arguments, so every rank computes the same tree."""
    radix = max(2, int(radix) if radix else tree_radix())
    sizes = parse_node_sizes(ppn) or [radix]
    groups: List[List[int]] = []
    r = i = 0
    while r < size:
        s = min(sizes[i % len(sizes)], size - r)
        groups.append(list(range(r, r + s)))
        r += s
        i += 1
    levels = [groups]
    while len(groups) > 1:
        leaders = [g[0] for g in groups]
        groups = [leaders[j:j + radix]
                  for j in range(0, len(leaders), radix)]
        levels.append(groups)
    return levels


def _tree_order(layout: List[List[List[int]]]) -> List[int]:
    """World ranks in the order the up phase concatenates them (subtrees
    contiguous, members in group order)."""
    lead_group = [{g[0]: g for g in groups} for groups in layout]

    def expand(level: int, member: int) -> List[int]:
        if level == 0:
            return [member]
        out: List[int] = []
        for c in lead_group[level - 1][member]:
            out.extend(expand(level - 1, c))
        return out

    top = len(layout) - 1
    order: List[int] = []
    for m in layout[top][0]:
        order.extend(expand(top, m))
    return order


class TreeOob(OobColl):
    """Tree-structured OOB allgather composed from per-group member OOBs:
    each node's members exchange through their own small store, node
    leaders through per-level parent stores of at most radix members, and
    the assembled result fans back down. One allgather costs O(log n)
    sequential store rounds. Requests are serialized (one starts once the
    previous finished), which keeps every group's round sequence the same
    on all members."""

    def __init__(self, rank: int, size: int, layout: List[List[List[int]]],
                 group_oobs: Dict[int, OobColl]):
        self.rank = int(rank)
        self.size = int(size)
        self.layout = layout
        self.group_oobs = group_oobs   # level -> my group's OOB (size > 1)
        self.top = len(layout) - 1
        self.my_groups: Dict[int, tuple] = {}
        for lvl, groups in enumerate(layout):
            for g in groups:
                if self.rank in g:
                    self.my_groups[lvl] = (g, g.index(self.rank))
                    break
        self._order = _tree_order(layout)
        self._queue: List[_TreeOobRequest] = []
        self.stats = {
            "levels": len(layout),
            "groups": sum(len(gs) for gs in layout),
            "max_fanin": max(len(g) for gs in layout for g in gs),
            "rounds": 0,          # group rounds this endpoint posted
            "allgathers": 0,
        }
        if metrics.ENABLED:
            metrics.gauge("oob_tree_levels", len(layout), component="oob")
            metrics.gauge("oob_tree_max_fanin", self.stats["max_fanin"],
                          component="oob")

    @property
    def oob_ep(self) -> int:
        return self.rank

    @property
    def n_oob_eps(self) -> int:
        return self.size

    def allgather(self, data: bytes) -> OobRequest:
        req = _TreeOobRequest(self, bytes(data))
        self._queue.append(req)
        self.stats["allgathers"] += 1
        if metrics.ENABLED:
            metrics.inc("oob_tree_allgathers", component="oob")
        self._drive()
        return req

    def _drive(self) -> None:
        while self._queue:
            if self._queue[0]._advance() == Status.IN_PROGRESS:
                return
            self._queue.pop(0)

    def _count_round(self) -> None:
        self.stats["rounds"] += 1
        if metrics.ENABLED:
            metrics.inc("oob_tree_rounds", component="oob")

    def close(self) -> None:
        for oob in self.group_oobs.values():
            close = getattr(oob, "close", None)
            if close is not None:
                close()


class _TreeOobRequest(OobRequest):
    """Up (gather per level), top merge, down (bcast per level); advanced
    only while at the head of its TreeOob's queue."""

    def __init__(self, oob: TreeOob, data: bytes):
        self.oob = oob
        self.data = data
        self.rounds = 0               # sequential group rounds consumed
        self._sub: List[bytes] = [data]   # my subtree, in tree order
        self._full: Optional[List[bytes]] = None
        self._stage = "up"
        self._lvl = 0
        self._dlvl = -1
        self._pending: Optional[OobRequest] = None
        self._result: Optional[List[bytes]] = None

    def test(self) -> Status:
        self.oob._drive()
        return Status.OK if self._result is not None \
            else Status.IN_PROGRESS

    @property
    def result(self) -> List[bytes]:
        if self._result is None:
            self.wait()
        assert self._result is not None
        return self._result

    def _post(self, lvl: int, blob: bytes) -> None:
        self._pending = self.oob.group_oobs[lvl].allgather(blob)
        self.rounds += 1
        self.oob._count_round()

    def _take(self) -> List[bytes]:
        entries = self._pending.result
        self._pending.free()
        self._pending = None
        return entries

    def _reorder(self) -> List[bytes]:
        out: List[Optional[bytes]] = [None] * self.oob.size
        for i, r in enumerate(self.oob._order):
            out[r] = self._sub[i]
        return out   # type: ignore[return-value]

    def _advance(self) -> Status:
        oob = self.oob
        top = oob.top
        while True:
            if self._stage == "up":
                lvl = self._lvl
                g, my = oob.my_groups[lvl]
                if len(g) == 1:
                    if lvl == top:
                        self._full = self._reorder()
                        self._stage = "down"
                        self._dlvl = lvl - 1
                        continue
                    self._lvl += 1
                    continue
                if self._pending is None:
                    self._post(lvl, pickle.dumps(self._sub))
                if self._pending.test() == Status.IN_PROGRESS:
                    return Status.IN_PROGRESS
                entries = self._take()
                if my == 0 or lvl == top:
                    merged: List[bytes] = []
                    for e in entries:
                        merged.extend(pickle.loads(e))
                    self._sub = merged
                if lvl == top:
                    self._full = self._reorder()
                    self._stage = "down"
                    self._dlvl = lvl - 1
                elif my == 0:
                    self._lvl += 1
                else:
                    # a non-leader gets the full result back through
                    # this group's bcast round
                    self._stage = "down_wait"
                continue
            if self._stage == "down_wait":
                lvl = self._lvl
                if self._pending is None:
                    self._post(lvl, b"")
                if self._pending.test() == Status.IN_PROGRESS:
                    return Status.IN_PROGRESS
                entries = self._take()
                self._full = pickle.loads(entries[0])   # the leader's
                self._stage = "down"
                self._dlvl = lvl - 1
                continue
            if self._stage == "down":
                lvl = self._dlvl
                if lvl < 0:
                    self._result = self._full
                    return Status.OK
                g, my = oob.my_groups[lvl]   # I lead every group below
                if len(g) == 1:
                    self._dlvl -= 1
                    continue
                if self._pending is None:
                    self._post(lvl, pickle.dumps(self._full))
                if self._pending.test() == Status.IN_PROGRESS:
                    return Status.IN_PROGRESS
                self._take()   # consume my own bcast round's reply
                self._dlvl -= 1
                continue


class ThreadTreeOobWorld:
    """In-process tree-OOB world: per-group ThreadOobWorlds stand in for
    the group stores, so the tree's round structure runs without
    sockets."""

    def __init__(self, n: int, ppn=None, radix: Optional[int] = None):
        self.n = n
        self.layout = tree_layout(n, ppn, radix)
        self._group_worlds: Dict[tuple, ThreadOobWorld] = {}
        for lvl, groups in enumerate(self.layout):
            for gi, g in enumerate(groups):
                if len(g) > 1:
                    self._group_worlds[(lvl, gi)] = ThreadOobWorld(len(g))

    def endpoint(self, rank: int) -> TreeOob:
        group_oobs: Dict[int, OobColl] = {}
        for lvl, groups in enumerate(self.layout):
            for gi, g in enumerate(groups):
                if rank in g and len(g) > 1:
                    group_oobs[lvl] = \
                        self._group_worlds[(lvl, gi)].endpoint(g.index(rank))
        return TreeOob(rank, self.n, self.layout, group_oobs)

    def endpoints(self) -> List[TreeOob]:
        return [self.endpoint(r) for r in range(self.n)]


class TcpTreeOob(TreeOob):
    """TCP tree bootstrap: each group of the layout is a TcpStoreOob whose
    server its first member hosts. Group stores bind ``base_port +
    group index`` in (level, group) order, so every rank computes the
    same port map; ``ports_needed`` sizes the block a job reserves. Every
    server binds on *host*: the layout models one host."""

    def __init__(self, rank: int, size: int, host: str = "127.0.0.1",
                 base_port: int = 29999, key: str = "", ppn=None,
                 radix: Optional[int] = None, timeout_s: float = 30.0,
                 bootstrap_timeout_s: Optional[float] = None):
        layout = tree_layout(size, ppn, radix)
        ports: Dict[tuple, int] = {}
        p = base_port
        for lvl, groups in enumerate(layout):
            for gi, g in enumerate(groups):
                if len(g) > 1:
                    ports[(lvl, gi)] = p
                    p += 1
        self._stores: List[TcpStoreOob] = []
        group_oobs: Dict[int, OobColl] = {}
        try:
            for lvl, groups in enumerate(layout):   # node stores first
                for gi, g in enumerate(groups):
                    if rank not in g or len(g) == 1:
                        continue
                    store = TcpStoreOob(
                        g.index(rank), len(g), host=host,
                        port=ports[(lvl, gi)],
                        key=f"{key}/tree-L{lvl}G{gi}",
                        timeout_s=timeout_s,
                        bootstrap_timeout_s=bootstrap_timeout_s)
                    self._stores.append(store)
                    group_oobs[lvl] = store
        except BaseException:
            for s in self._stores:
                s.close()
            raise
        super().__init__(rank, size, layout, group_oobs)

    @staticmethod
    def ports_needed(size: int, ppn=None,
                     radix: Optional[int] = None) -> int:
        """The size of the contiguous port block one TcpTreeOob takes
        from its base_port."""
        return sum(1 for groups in tree_layout(size, ppn, radix)
                   for g in groups if len(g) > 1)

    def close(self) -> None:
        for s in self._stores:
            s.close()


# ---------------------------------------------------------------------------
# TCP store OOB (multi-process bootstrap)
# ---------------------------------------------------------------------------

# every store frame carries a crc32 of its payload, always verified: a
# flipped bit here would poison the pickled addresses of the whole job. A
# mismatch is a typed error, not a retry: the stream has desynced.
_MSG = struct.Struct("!III")   # rank, payload length, payload crc32
_RSP = struct.Struct("!II")    # response: blob length, blob crc32


def _store_cookie(key: str, size: int) -> bytes:
    """Per-job handshake cookie: magic + digest of (user key, size), so a
    client that reaches another job's store is rejected, not enrolled."""
    import hashlib
    return b"UCCS" + hashlib.sha1(
        f"{key}:{size}".encode()).digest()[:8]


def _connect(addr: Tuple[str, int], timeout: float) -> socket.socket:
    """``socket.create_connection`` with SO_REUSEADDR set before the
    connect. The connecting side closes first, so its ephemeral port waits
    in TIME_WAIT; such an entry refuses a later SO_REUSEADDR bind of the
    same port (a store or listener handed it) unless it had the option
    too."""
    err: Optional[OSError] = None
    for af, kind, proto, _, sa in socket.getaddrinfo(
            addr[0], addr[1], 0, socket.SOCK_STREAM):
        s = socket.socket(af, kind, proto)
        try:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.settimeout(timeout)
            s.connect(sa)
            return s
        except OSError as e:
            err = e
            s.close()
    raise err if err is not None else OSError(f"no address for {addr}")


def _shut(sock: Optional[socket.socket]) -> None:
    """Shut a socket down and close it: shutdown wakes a thread blocked in
    accept or recv on it, which a bare close does not. The close is
    graceful: the peer still receives every byte queued before it."""
    if sock is None:
        return
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class TcpStoreOob(OobColl):
    """Rank 0 hosts a small allgather server; every rank (rank 0 too)
    connects to it. Exposed through the nonblocking OobRequest contract.
    ``close()`` shuts the connection and, on rank 0, the server and its
    thread."""

    def __init__(self, rank: int, size: int, host: str = "127.0.0.1",
                 port: int = 29999, key: str = "",
                 timeout_s: float = 30.0,
                 bootstrap_timeout_s: Optional[float] = None):
        self.rank = rank
        self.size = size
        self.addr = (host, port)
        cookie = _store_cookie(key, size)
        self._server: Optional[_StoreServer] = None
        self._sock: Optional[socket.socket] = None
        if rank == 0:
            self._server = _StoreServer(
                size, (host, port), cookie,
                bootstrap_timeout_s if bootstrap_timeout_s is not None
                else BOOTSTRAP_TIMEOUT)
        deadline = time.monotonic() + timeout_s
        backoff = CONNECT_BACKOFF_BASE
        while True:
            # each attempt's timeout is capped to the remaining deadline
            att = max(0.2, min(5.0, deadline - time.monotonic()))
            try:
                self._sock = _connect(self.addr, att)
                self._sock.setsockopt(socket.IPPROTO_TCP,
                                      socket.TCP_NODELAY, 1)
                # the server identifies itself with the cookie, then the
                # client registers its rank; only validated
                # registrations take a slot
                got = _recv_exact(self._sock, len(cookie))
                if got != cookie:
                    raise OSError(f"not this job's store (got {got!r})")
                self._sock.sendall(cookie + struct.pack("!I", rank))
                self._sock.settimeout(None)
                break
            except OSError:
                _shut(self._sock)
                self._sock = None
                if time.monotonic() > deadline:
                    if self._server is not None:
                        self._server.close()
                        self._server = None
                    raise
                sleep = min(backoff, max(0.0,
                                         deadline - time.monotonic()))
                time.sleep(sleep * random.uniform(0.5, 1.0))
                backoff = min(backoff * 2, CONNECT_BACKOFF_MAX)

    @property
    def oob_ep(self) -> int:
        return self.rank

    @property
    def n_oob_eps(self) -> int:
        return self.size

    def allgather(self, data: bytes) -> OobRequest:
        sock = self._sock
        if sock is None:
            raise UccError(Status.ERR_INVALID_PARAM, "TcpStoreOob is closed")
        sock.sendall(_MSG.pack(self.rank, len(data),
                               zlib.crc32(data) & 0xFFFFFFFF) + data)
        return _TcpOobRequest(sock, self.size)

    def close(self) -> None:
        sock, self._sock = self._sock, None
        _shut(sock)
        server, self._server = self._server, None
        if server is not None:
            server.close()


class _TcpOobRequest(OobRequest):
    """Nonblocking: ``test`` drains the bytes that are ready and returns
    IN_PROGRESS until the whole blob (one pickled list of every
    contribution) has arrived. It never reads past this request's blob:
    the next allgather's response shares the socket."""

    def __init__(self, sock: socket.socket, size: int):
        self.sock = sock
        self.size = size
        self._buf = b""
        self._need: Optional[int] = None
        self._crc = 0
        self._result: Optional[List[bytes]] = None

    def test(self) -> Status:
        if self._result is not None:
            return Status.OK
        while True:
            if not _readable(self.sock, 0):
                return Status.IN_PROGRESS
            want = (_RSP.size - len(self._buf)) if self._need is None \
                else (self._need - len(self._buf))
            chunk = self.sock.recv(want)
            if not chunk:
                raise ConnectionError("OOB peer closed")
            self._buf += chunk
            if self._need is None and len(self._buf) >= _RSP.size:
                ln, self._crc = _RSP.unpack(self._buf[:_RSP.size])
                self._need = _RSP.size + ln
            if self._need is not None and len(self._buf) >= self._need:
                raw = self._buf[_RSP.size:self._need]
                if zlib.crc32(raw) & 0xFFFFFFFF != self._crc:
                    if metrics.ENABLED:
                        metrics.inc("integrity_wire_mismatch",
                                    component="core/oob")
                    raise UccError(
                        Status.ERR_DATA_CORRUPTED,
                        "store response failed crc32 verification "
                        "(corrupted bootstrap frame)")
                blob = pickle.loads(raw)
                if isinstance(blob, dict) and "__ucc_oob_error__" in blob:
                    # the server's bootstrap failure frame
                    raise UccError(
                        Status.ERR_TIMED_OUT,
                        f"OOB bootstrap failed: "
                        f"{blob.get('__ucc_oob_error__')}; absent ranks "
                        f"{blob.get('absent')}")
                self._result = blob
                return Status.OK

    @property
    def result(self) -> List[bytes]:
        while self.test() == Status.IN_PROGRESS:
            _readable(self.sock, 0.05)
        assert self._result is not None
        return self._result


def _readable(sock: socket.socket, timeout: float) -> bool:
    """Poll one socket for readability through selectors (select() caps
    descriptors at 1024)."""
    sel = selectors.DefaultSelector()
    try:
        sel.register(sock, selectors.EVENT_READ)
        return bool(sel.select(timeout))
    finally:
        sel.close()


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("OOB peer closed")
        buf += chunk
    return buf


class _StoreServer:
    def __init__(self, size: int, addr, cookie: bytes,
                 bootstrap_timeout_s: float = 0.0):
        self.size = size
        self.cookie = cookie
        self.bootstrap_timeout_s = bootstrap_timeout_s
        self.lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self.lsock.bind(addr)
            self.lsock.listen(size + 8)
        except OSError:
            self.lsock.close()
            raise
        self.conns: List[socket.socket] = []
        self._closed = False
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="ucc-oob-store")
        self.thread.start()

    def _register(self, c: socket.socket) -> Optional[int]:
        """Cookie out, cookie + rank back, rank bound-checked. Returns the
        rank, or None (connection closed) for strangers and dead probes."""
        try:
            c.settimeout(10)
            c.sendall(self.cookie)
            echo = _recv_exact(c, len(self.cookie) + 4)
            if echo[:len(self.cookie)] != self.cookie:
                raise OSError("bad cookie echo")
            (rank,) = struct.unpack("!I", echo[len(self.cookie):])
            if not 0 <= rank < self.size:
                raise OSError(f"rank {rank} out of range")
            c.settimeout(None)
            return rank
        except (ConnectionError, OSError):
            _shut(c)
            return None

    def _bootstrap_fail(self, registered: set) -> None:
        """Fail the registered ranks with a typed frame naming the ranks
        that never arrived, then close."""
        absent = sorted(set(range(self.size)) - registered)
        logger.error(
            "store server: bootstrap timed out after %.1fs with %d/%d "
            "ranks registered; absent ranks: %s", self.bootstrap_timeout_s,
            len(registered), self.size, absent)
        blob = pickle.dumps({"__ucc_oob_error__": "bootstrap timed out",
                             "absent": absent})
        out = _RSP.pack(len(blob), zlib.crc32(blob) & 0xFFFFFFFF) + blob
        for c in self.conns:
            try:
                c.sendall(out)
            except OSError:
                pass
        self._shutdown()

    def _run(self) -> None:
        try:
            registered: set = set()
            deadline = (time.monotonic() + self.bootstrap_timeout_s
                        if self.bootstrap_timeout_s > 0 else None)
            self.lsock.settimeout(0.25)
            while len(registered) < self.size:
                if self._closed:
                    return
                if deadline is not None and time.monotonic() > deadline:
                    self._bootstrap_fail(registered)
                    return
                try:
                    c, _ = self.lsock.accept()
                except socket.timeout:
                    continue
                c.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                rank = self._register(c)
                if rank is None:
                    continue
                if rank in registered:
                    # a re-claimed rank must not take a second slot
                    logger.warning("store server: duplicate registration "
                                   "for rank %d rejected", rank)
                    _shut(c)
                    continue
                registered.add(rank)
                self.conns.append(c)
            while True:
                contribs: List[Optional[bytes]] = [None] * self.size
                for c in list(self.conns):
                    hdr = _recv_exact(c, _MSG.size)
                    rank, ln, crc = _MSG.unpack(hdr)
                    if not 0 <= rank < self.size:
                        raise OSError(f"stray rank {rank} on store conn")
                    payload = _recv_exact(c, ln)
                    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                        raise OSError(
                            f"store contribution from rank {rank} "
                            f"failed crc32 verification")
                    contribs[rank] = payload
                blob = pickle.dumps(contribs)
                out = _RSP.pack(len(blob),
                                zlib.crc32(blob) & 0xFFFFFFFF) + blob
                for c in self.conns:
                    c.sendall(out)
        except (ConnectionError, OSError, ValueError):
            return

    def _shutdown(self) -> None:
        self._closed = True
        _shut(self.lsock)
        for c in self.conns:
            _shut(c)

    def close(self) -> None:
        self._shutdown()
        if self.thread is not threading.current_thread():
            self.thread.join(timeout=5)
