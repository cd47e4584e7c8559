"""Collective-program IR — per-rank dataflow over symbolic chunks (the
port's copy of ``ucc_tpu/dsl/ir.py``).

A :class:`Program` describes one collective algorithm for one concrete
team size as a set of per-rank instruction streams. The data model:

- The collective's vector is split into ``nchunks`` near-equal chunks
  (the standard ``ucc_buffer_block_count/offset`` split, so any element
  count works). Chunk ``c`` of every rank's buffer refers to the SAME
  vector slice — programs move and combine *contributions* to slices,
  never raw offsets.
- Ops are grouped into ``rounds``. Execution posts every op of a round
  nonblocking, waits for all of them, applies the round's local
  reductions/copies, then advances — the same shape as the hand-written
  generator algorithms of the host TLs, so the compiled task inherits their
  cancellation/fault/observability behavior unchanged.
- Matching is by ``(src_rank, dst_rank, slot)``: a ``send`` on rank
  ``p`` with slot ``s`` to ``q`` pairs with exactly one ``recv`` or
  ``reduce`` on rank ``q`` with peer ``p`` and slot ``s`` (the verifier
  enforces 1:1 matching). The builder auto-assigns collision-free slots
  (``round * nchunks + chunk``); authors only pass ``slot=`` explicitly
  to express deliberate cross-round matches.

Op kinds:

``SEND(chunk, peer)``
    Post chunk ``chunk``'s current content to ``peer``.
``RECV(chunk, peer)``
    Receive into chunk ``chunk``, REPLACING its content (allgather-style
    data movement).
``REDUCE(chunk, peer)``
    Receive the peer's copy of chunk ``chunk`` into a temporary and
    reduce it into the local chunk with the collective's operator
    (reduce-scatter-style accumulation).
``COPY(chunk, src_chunk)``
    Local chunk-to-chunk copy (applied after the round's deliveries).
``PUT(chunk, peer)`` / ``PUT_RED(chunk, peer)``
    One-sided put+flag through a process-shared arena window (the
    pooled tier): the sender copies chunk ``chunk``'s current content
    into a named window cell and releases a flag word; the target
    consumes it at its OWN round ``k`` (the round the put was issued
    in) — overwriting the chunk (``PUT``) or reducing into it
    (``PUT_RED``). There is no receiver-side op: the executor derives
    each rank's incoming-put list from the full program. The sender
    never blocks on the target (no rendezvous edge in the wait graph),
    which is what makes the tier one-sided. Puts sharing a
    ``(sender, slot)`` pair write ONE window read by every target
    (the fan-out broadcast case), so the verifier requires them to
    agree on round and chunk. Only teams whose transport exposes a
    shared-memory arena can run window programs; everywhere
    else the compiled task raises NOT_SUPPORTED and the fallback walk
    picks a two-sided candidate.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..constants import CollType

#: IR + verifier semantics version. Bumped whenever the meaning of a
#: serialized Program changes (new op fields, new postcondition models,
#: executor contract changes) — the on-disk verified-program cache
#: (registry._disk_cache) keys every entry by this, so a stale cache
#: can never replay a program under semantics it was not verified for.
#: v3: one-sided PUT/PUT_RED window ops (the pooled tier).
DSL_VERSION = 3


class OpKind(enum.IntEnum):
    SEND = 0
    RECV = 1
    REDUCE = 2
    COPY = 3
    PUT = 4        # one-sided window put (overwrites the target chunk)
    PUT_RED = 5    # one-sided window put reduced into the target chunk


#: the one-sided window kinds (matched by derivation, not by a
#: receiver-side op)
PUT_KINDS = frozenset((OpKind.PUT, OpKind.PUT_RED))


@dataclass(frozen=True)
class Op:
    """One IR instruction. ``peer`` is the remote rank for wire ops and
    unused (-1) for COPY; ``src_chunk`` is only meaningful for COPY.
    ``wire`` quantizes this single edge ("int8"/"fp8"; empty = exact) —
    hierarchical programs use it to compress DCN-class edges while the
    intra-node edges stay exact. Both sides of a matched edge must
    declare the same wire precision (the verifier enforces it)."""

    kind: OpKind
    chunk: int
    peer: int = -1
    slot: int = 0
    src_chunk: int = -1
    wire: str = ""

    def describe(self) -> str:
        k = self.kind.name.lower()
        if self.kind == OpKind.COPY:
            return f"copy(chunk {self.src_chunk} -> {self.chunk})"
        d = "to" if self.kind in (OpKind.SEND, OpKind.PUT,
                                  OpKind.PUT_RED) else "from"
        q = f", q{self.wire}" if self.wire else ""
        return (f"{k}(chunk {self.chunk} {d} rank {self.peer}, "
                f"slot {self.slot}{q})")


@dataclass
class RankProgram:
    """One rank's instruction stream: ``rounds[k]`` is the op list of
    round ``k``. Every rank of a program has the same round count (a
    rank idle in a round simply has an empty list)."""

    rounds: List[List[Op]] = field(default_factory=list)


@dataclass
class Program:
    """A compiled-form collective program for one concrete team size."""

    name: str                    #: algorithm name (score map / TUNE / tuner)
    family: str                  #: generator family, e.g. "ring"
    params: Dict[str, int]       #: family parameters, e.g. {"chunks": 4}
    coll: CollType
    nranks: int
    nchunks: int
    ranks: List[RankProgram]
    #: wire precision for fused quantized programs ("int8"/"fp8"; empty
    #: = exact). The compiler inserts the block codec at send edges.
    wire: str = ""

    @property
    def n_rounds(self) -> int:
        return len(self.ranks[0].rounds) if self.ranks else 0

    @property
    def edge_wire_mode(self) -> str:
        """The single per-edge wire precision used by this program's
        quantized edges ("" = none). Mixed modes are rejected by the
        verifier, so the first one found is THE one. Memoized: the scan
        is O(all ops) and this sits on the per-collective init path
        (the generated tasks' eligibility checks)."""
        v = self.__dict__.get("_edge_wire_mode")
        if v is None:
            v = ""
            for rp in self.ranks:
                for ops in rp.rounds:
                    for op in ops:
                        if op.wire:
                            v = op.wire
                            break
                    if v:
                        break
                if v:
                    break
            self.__dict__["_edge_wire_mode"] = v
        return v

    @property
    def uses_windows(self) -> bool:
        """True when any rank's stream holds a one-sided PUT/PUT_RED —
        the program needs a process-shared arena and can never
        lower to a native mailbox plan. Memoized like edge_wire_mode
        (this sits on the per-collective init path)."""
        v = self.__dict__.get("_uses_windows")
        if v is None:
            v = any(op.kind in PUT_KINDS
                    for rp in self.ranks
                    for ops in rp.rounds
                    for op in ops)
            self.__dict__["_uses_windows"] = v
        return v

    def block_chunks(self, rank: int) -> range:
        """Chunk indices of *rank*'s owned vector block (the standard
        rank-block layout: nchunks = nranks * m, block b = chunks
        [b*m, (b+1)*m)). Meaningful for allgather/reduce_scatter
        programs, whose ownership is part of the collective contract."""
        m = self.nchunks // self.nranks
        return range(rank * m, (rank + 1) * m)

    @property
    def param_str(self) -> str:
        """Human/provenance form, e.g. ``ring(chunks=4)`` — shown in the
        score dump's generated column and carried into tuner cache
        entries and sweep measurement records."""
        inner = ",".join(f"{k}={v}" for k, v in sorted(self.params.items()))
        if self.wire:
            inner = f"{inner},{self.wire}" if inner else self.wire
        return f"{self.family}({inner})"

    def __repr__(self):
        return (f"Program({self.name}, n={self.nranks}, "
                f"chunks={self.nchunks}, rounds={self.n_rounds})")


class ProgramBuilder:
    """Author API for program generators.

    Usage::

        b = ProgramBuilder("ring", CollType.ALLREDUCE, nranks=4,
                           nchunks=4, params={"chunks": 1})
        for step in range(3):
            b.next_round()
            for me in range(4):
                b.send(me, chunk, to=right)
                b.reduce(me, chunk, frm=left)
        prog = b.build("gen_ring_c1")

    Rounds are global: ``next_round()`` advances every rank's stream at
    once (generated programs are symmetric; a rank with no ops in a
    round is simply idle). Slots default to ``round * nchunks + chunk``
    — unique per (src, dst) within a round and across rounds — and can
    be overridden for deliberate cross-round matches.
    """

    def __init__(self, family: str, coll: CollType, nranks: int,
                 nchunks: int, params: Optional[Dict[str, int]] = None,
                 wire: str = ""):
        if nranks < 1:
            raise ValueError(f"nranks must be >= 1 (got {nranks})")
        if nchunks < 1:
            raise ValueError(f"nchunks must be >= 1 (got {nchunks})")
        self.family = family
        self.coll = coll
        self.nranks = nranks
        self.nchunks = nchunks
        self.params = dict(params or {})
        self.wire = wire
        self._rounds: List[List[List[Op]]] = []   # [round][rank] -> ops
        self._round = -1

    # ------------------------------------------------------------------
    def next_round(self) -> int:
        self._rounds.append([[] for _ in range(self.nranks)])
        self._round += 1
        return self._round

    def _auto_slot(self, chunk: int) -> int:
        return self._round * self.nchunks + chunk

    def _check(self, rank: int, chunk: int, peer: Optional[int]) -> None:
        if self._round < 0:
            raise ValueError("no open round: call next_round() first")
        if not 0 <= rank < self.nranks:
            raise ValueError(f"rank {rank} out of range [0, {self.nranks})")
        if not 0 <= chunk < self.nchunks:
            raise ValueError(f"chunk {chunk} out of range "
                             f"[0, {self.nchunks})")
        if peer is not None:
            if not 0 <= peer < self.nranks:
                raise ValueError(f"peer {peer} out of range "
                                 f"[0, {self.nranks})")
            if peer == rank:
                raise ValueError(f"rank {rank}: self-send/recv")

    def send(self, rank: int, chunk: int, to: int,
             slot: Optional[int] = None, wire: str = "") -> None:
        self._check(rank, chunk, to)
        self._rounds[self._round][rank].append(
            Op(OpKind.SEND, chunk, to,
               self._auto_slot(chunk) if slot is None else slot,
               wire=wire))

    def recv(self, rank: int, chunk: int, frm: int,
             slot: Optional[int] = None, wire: str = "") -> None:
        self._check(rank, chunk, frm)
        self._rounds[self._round][rank].append(
            Op(OpKind.RECV, chunk, frm,
               self._auto_slot(chunk) if slot is None else slot,
               wire=wire))

    def reduce(self, rank: int, chunk: int, frm: int,
               slot: Optional[int] = None, wire: str = "") -> None:
        self._check(rank, chunk, frm)
        self._rounds[self._round][rank].append(
            Op(OpKind.REDUCE, chunk, frm,
               self._auto_slot(chunk) if slot is None else slot,
               wire=wire))

    def put(self, rank: int, chunk: int, to: int,
            slot: Optional[int] = None) -> None:
        """One-sided window put: overwrite chunk ``chunk`` on rank
        ``to`` with my current value, consumed at the target's round.
        Puts never carry a wire precision (the pooled tier is exact)."""
        self._check(rank, chunk, to)
        self._rounds[self._round][rank].append(
            Op(OpKind.PUT, chunk, to,
               self._auto_slot(chunk) if slot is None else slot))

    def put_red(self, rank: int, chunk: int, to: int,
                slot: Optional[int] = None) -> None:
        """One-sided window put reduced into the target chunk with the
        collective's operator (applied in deterministic source-rank
        order on the target)."""
        self._check(rank, chunk, to)
        self._rounds[self._round][rank].append(
            Op(OpKind.PUT_RED, chunk, to,
               self._auto_slot(chunk) if slot is None else slot))

    def copy(self, rank: int, dst_chunk: int, src_chunk: int) -> None:
        self._check(rank, dst_chunk, None)
        self._check(rank, src_chunk, None)
        self._rounds[self._round][rank].append(
            Op(OpKind.COPY, dst_chunk, -1, 0, src_chunk))

    # ------------------------------------------------------------------
    def build(self, name: str) -> Program:
        ranks = [RankProgram(rounds=[self._rounds[k][r]
                                     for k in range(len(self._rounds))])
                 for r in range(self.nranks)]
        return Program(name=name, family=self.family, params=self.params,
                       coll=self.coll, nranks=self.nranks,
                       nchunks=self.nchunks, ranks=ranks, wire=self.wire)
