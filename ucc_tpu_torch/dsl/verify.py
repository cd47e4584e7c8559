"""Static verifier for collective programs (the port's copy of
``ucc_tpu/dsl/verify.py``, with the same rules and messages).

Every generated program is verified BEFORE registration; a program that
fails verification is rejected (the registry logs and skips it — a
broken generator can never ship a wrong or hanging algorithm). Two
independent proofs:

**Postcondition (symbolic chunk tracking).** Each (rank, chunk) location
holds a symbolic value: the *set of source ranks whose contribution to
that vector slice has been accumulated*. Initially rank ``r`` holds
``{r}`` in every chunk (its own input). ``SEND`` snapshots the sender's
set at post time; ``RECV`` replaces the destination set; ``REDUCE``
unions it in — rejecting overlap, because with a real reduction
operator an overlapping union means some rank's contribution is summed
twice (silent wrong answers for SUM/PROD). After the last round, every
rank's every chunk must equal the collective's postcondition — for
allreduce, the full set ``{0..n-1}``.

The postcondition model covers four collectives: allreduce
(every rank's every chunk ends as the full reduction), reduce_scatter
(every rank's OWNED block ends as the full reduction; other chunks are
unconstrained scratch), allgather (every chunk ends as exactly its
owner's contribution, everywhere), and bcast (every chunk ends as rank
0's contribution — programs are generated for root 0 and the compiler
rotates ranks for other roots). Non-reducing collectives (allgather,
bcast) reject REDUCE ops outright — there is no reduction operator to
apply. Locations that start without data (allgather non-owned blocks,
bcast non-roots) hold an "undefined" marker; reducing undefined data is
an error, and a chunk still undefined at the end fails the
postcondition.

**Deadlock-freedom (round-ordered wait graph).** Execution is
round-ordered per rank: round ``k`` posts all its wire ops, then waits
for all of them. Completing round ``k`` on rank ``r`` therefore
requires (a) rank ``r`` completed round ``k-1``, (b) every matched
sender posted its send — i.e. completed the round *before* the send's —
and (c) every matched receiver posted its recv (the conservative
rendezvous model: a large send completes only once the peer's recv is
up). Those are exactly the edges of a directed graph over
``(rank, round)`` completion nodes; the program is deadlock-free iff
that graph is acyclic. The check also enforces 1:1 send/recv matching —
an unmatched recv is a guaranteed hang, an unmatched send a guaranteed
stray message into a later collective's tag space.

**One-sided window puts (the pooled tier).** ``PUT``/``PUT_RED`` ops
have no receiver-side op: consumption is derived — the target applies
every put issued at round ``k`` during its OWN round ``k``, after its
two-sided wire ops complete. They are therefore EXCLUDED from 1:1
send/recv matching and modeled separately: puts sharing a
``(sender, slot)`` pair write one window cell (the fan-out broadcast
case) and must agree on round, chunk and kind; the wait graph gains
only the forward edge (sender posted round k) -> (target completes
round k) — a put never blocks the sender, so the conservative
rendezvous back-edge does not exist for this class. Hazard rules
mirror RECV's: at most one overwriting put per (target, round, chunk),
never mixed with a two-sided delivery or a reducing put into the same
chunk. ``PUT_RED`` deliveries reduce in deterministic source-rank
order and get the same double-count/undefined checks as ``REDUCE``.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Tuple

from ..constants import CollType
from .ir import PUT_KINDS, Op, OpKind, Program

#: number of symbolically-tracked values per location; contribution sets
#: are frozensets of source ranks
_Val = FrozenSet[int]


class VerifyError(Exception):
    """A program failed static verification. ``rank``/``chunk``/``round``
    name the first offending location (when attributable) so the
    diagnostic points at the generator bug, not just at 'invalid'."""

    def __init__(self, reason: str, rank: Optional[int] = None,
                 chunk: Optional[int] = None, round_: Optional[int] = None):
        self.rank = rank
        self.chunk = chunk
        self.round = round_
        where = []
        if rank is not None:
            where.append(f"rank {rank}")
        if round_ is not None:
            where.append(f"round {round_}")
        if chunk is not None:
            where.append(f"chunk {chunk}")
        prefix = f"[{', '.join(where)}] " if where else ""
        super().__init__(prefix + reason)


def _match_ops(prog: Program):
    """1:1 send/recv matching by (src, dst, slot). Returns
    ``{(p, q, slot): ((p, round_s, send_op), (q, round_r, recv_op))}``.
    """
    sends: Dict[Tuple[int, int, int], Tuple[int, int, Op]] = {}
    recvs: Dict[Tuple[int, int, int], Tuple[int, int, Op]] = {}
    for r, rp in enumerate(prog.ranks):
        for k, ops in enumerate(rp.rounds):
            for op in ops:
                if op.kind == OpKind.SEND:
                    key = (r, op.peer, op.slot)
                    if key in sends:
                        raise VerifyError(
                            f"duplicate send to rank {op.peer} slot "
                            f"{op.slot} (first in round "
                            f"{sends[key][1]})", rank=r, chunk=op.chunk,
                            round_=k)
                    sends[key] = (r, k, op)
                elif op.kind in (OpKind.RECV, OpKind.REDUCE):
                    key = (op.peer, r, op.slot)
                    if key in recvs:
                        raise VerifyError(
                            f"duplicate recv from rank {op.peer} slot "
                            f"{op.slot} (first in round "
                            f"{recvs[key][1]})", rank=r, chunk=op.chunk,
                            round_=k)
                    recvs[key] = (r, k, op)
    for key, (r, k, op) in sends.items():
        if key not in recvs:
            raise VerifyError(
                f"unmatched {op.describe()} — no rank posts the "
                f"receiving side", rank=r, chunk=op.chunk, round_=k)
    for key, (r, k, op) in recvs.items():
        if key not in sends:
            raise VerifyError(
                f"unmatched {op.describe()} — no rank posts the "
                f"sending side (guaranteed hang)", rank=r, chunk=op.chunk,
                round_=k)
    return {key: (sends[key], recvs[key]) for key in sends}


def _collect_puts(prog: Program):
    """Derive the one-sided put structure. Returns ``(groups,
    incoming)``: ``groups`` maps window identity ``(sender, slot)`` to
    ``(round, chunk, kind, [targets])`` — all puts sharing a
    (sender, slot) write ONE window cell, so they must agree on round,
    chunk and kind, and may not name a target twice; ``incoming`` maps
    ``(target, round)`` to the delivery list ``[(sender, op), ...]``
    sorted by (sender, slot) — the deterministic order the executor
    (and the symbolic model) applies them in."""
    groups: Dict[Tuple[int, int], Tuple[int, int, OpKind, List[int]]] = {}
    incoming: Dict[Tuple[int, int], List[Tuple[int, Op]]] = {}
    for p, rp in enumerate(prog.ranks):
        for k, ops in enumerate(rp.rounds):
            for op in ops:
                if op.kind not in PUT_KINDS:
                    continue
                if op.wire or prog.wire:
                    raise VerifyError(
                        f"{op.describe()} carries a wire precision — "
                        f"window puts are exact (the pooled tier has "
                        f"no edge codec)", rank=p, chunk=op.chunk,
                        round_=k)
                g = groups.get((p, op.slot))
                if g is None:
                    groups[(p, op.slot)] = (k, op.chunk, op.kind,
                                            [op.peer])
                else:
                    gk, gc, gkind, dsts = g
                    if gk != k or gc != op.chunk or gkind != op.kind:
                        raise VerifyError(
                            f"{op.describe()} reuses window slot "
                            f"{op.slot} of round {gk} chunk {gc} "
                            f"({gkind.name}) — puts sharing a "
                            f"(sender, slot) write one window cell and "
                            f"must agree on round, chunk and kind",
                            rank=p, chunk=op.chunk, round_=k)
                    if op.peer in dsts:
                        raise VerifyError(
                            f"duplicate {op.describe()} — the same "
                            f"window already targets rank {op.peer}",
                            rank=p, chunk=op.chunk, round_=k)
                    dsts.append(op.peer)
                incoming.setdefault((op.peer, k), []).append((p, op))
    for lst in incoming.values():
        lst.sort(key=lambda e: (e[0], e[1].slot))
    return groups, incoming


def _topo_rounds(prog: Program, matches, incoming) -> List[Tuple[int, int]]:
    """Topological order of (rank, round) completion nodes, or raise
    VerifyError naming a node on a cycle (the deadlock)."""
    n, R = prog.nranks, prog.n_rounds
    nodes = [(r, k) for r in range(n) for k in range(R)]
    edges: Dict[Tuple[int, int], List[Tuple[int, int]]] = {u: [] for u in nodes}
    indeg = {u: 0 for u in nodes}

    def add(u, v):
        if u[1] < 0:          # waiting on "before round 0" is free
            return
        edges[u].append(v)
        indeg[v] += 1

    for r in range(n):
        for k in range(1, R):
            add((r, k - 1), (r, k))
    for (sender, recver) in matches.values():
        p, ks, _sop = sender
        q, kr, _rop = recver
        # receiver's round-kr wait needs the sender to have POSTED round
        # ks, i.e. completed ks-1
        add((p, ks - 1), (q, kr))
        # sender's round-ks wait needs the receiver's recv to be up
        # (conservative rendezvous model)
        add((q, kr - 1), (p, ks))
    # one-sided puts: the target consumes an issued-at-round-k put
    # during its own round k, so it waits on the sender having POSTED
    # round k (completed k-1). No reverse edge — a put never blocks
    # the sender (that is what makes the tier one-sided).
    for (q, k), lst in incoming.items():
        for (p, _op) in lst:
            add((p, k - 1), (q, k))

    order: List[Tuple[int, int]] = []
    ready = [u for u in nodes if indeg[u] == 0]
    while ready:
        u = ready.pop()
        order.append(u)
        for v in edges[u]:
            indeg[v] -= 1
            if indeg[v] == 0:
                ready.append(v)
    if len(order) != len(nodes):
        # every leftover node sits on (or behind) a cycle; report the
        # first wire op of the smallest stuck node for a stable message
        stuck = sorted(u for u in nodes if indeg[u] > 0)
        r, k = stuck[0]
        ops = [op for op in prog.ranks[r].rounds[k]
               if op.kind != OpKind.COPY]
        detail = ops[0].describe() if ops else "round barrier"
        raise VerifyError(
            f"cyclic wait dependency (deadlock): {detail} can never "
            f"complete — {len(stuck)} (rank, round) states wait on each "
            f"other", rank=r, chunk=ops[0].chunk if ops else None,
            round_=k)
    return order


def _check_round_hazards(prog: Program, incoming) -> None:
    """Intra-round buffer hazards the symbolic model cannot see.

    The executor posts a round's sends and recvs concurrently, and an
    overwriting RECV delivers STRAIGHT into the chunk's view of the
    user vector at transport-arrival time. So within one round on one
    rank, a RECV destination chunk must be exclusive:

    - RECV dst ∩ SEND src races — the incoming delivery can overwrite
      the slice before a parked zero-copy send of it is consumed (the
      model's snapshot-at-post semantics silently assume otherwise);
    - two deliveries into one chunk where any is a RECV resolve in
      transport-arrival order, which is timing-dependent — the model's
      program-order resolution would be fiction.

    SEND+REDUCE on one chunk and multiple REDUCEs are safe: reduces
    land in temporaries and apply after the round's wait (sends have
    completed — delivered or staged — by then), in deterministic
    program order, and disjoint unions commute.

    One-sided put deliveries (``incoming`` maps (target, round) to
    them) apply from the window AFTER the target's own wire ops
    complete, so a put destination may coexist with a SEND source
    (the window is the staging copy). What stays forbidden: two
    overwriting puts into one chunk (one silently wins — a generator
    bug), and an overwriting put mixed with ANY other delivery into
    the same chunk (recv, reduce or reducing put — the survivor would
    depend on apply order, which the model refuses to make load-
    bearing). A reducing put mixed with an overwriting RECV is
    rejected for the same reason.
    """
    for r, rp in enumerate(prog.ranks):
        for k, ops in enumerate(rp.rounds):
            send_src = set()
            recv_dst = set()
            reduce_dst = set()
            put_over_dst = set()
            put_red_dst = set()
            for (_p, pop) in incoming.get((r, k), ()):
                if pop.kind == OpKind.PUT:
                    if pop.chunk in put_over_dst:
                        raise VerifyError(
                            f"two overwriting puts into chunk "
                            f"{pop.chunk} within one round — one "
                            f"write silently wins", rank=r,
                            chunk=pop.chunk, round_=k)
                    put_over_dst.add(pop.chunk)
                else:
                    put_red_dst.add(pop.chunk)
            for op in ops:
                if op.kind == OpKind.SEND:
                    send_src.add(op.chunk)
                elif op.kind == OpKind.RECV:
                    if op.chunk in recv_dst:
                        raise VerifyError(
                            f"two overwriting recvs into chunk "
                            f"{op.chunk} within one round — resolution "
                            f"order is transport-timing-dependent",
                            rank=r, chunk=op.chunk, round_=k)
                    recv_dst.add(op.chunk)
                elif op.kind == OpKind.REDUCE:
                    reduce_dst.add(op.chunk)
            for c in sorted(recv_dst & reduce_dst):
                raise VerifyError(
                    f"multiple deliveries into chunk {c} within one "
                    f"round with an overwriting recv — resolution "
                    f"order is transport-timing-dependent", rank=r,
                    chunk=c, round_=k)
            for c in sorted(send_src & recv_dst):
                raise VerifyError(
                    f"chunk {c} is both a send source and an "
                    f"overwriting recv destination in one round — the "
                    f"incoming delivery can overwrite the slice before "
                    f"the outgoing send is consumed", rank=r, chunk=c,
                    round_=k)
            for c in sorted(put_over_dst
                            & (recv_dst | reduce_dst | put_red_dst)):
                raise VerifyError(
                    f"chunk {c} takes an overwriting put and another "
                    f"delivery within one round — the survivor would "
                    f"depend on apply order", rank=r, chunk=c, round_=k)
            for c in sorted(put_red_dst & recv_dst):
                raise VerifyError(
                    f"chunk {c} takes a reducing put and an "
                    f"overwriting recv within one round — the recv "
                    f"resolves at transport-arrival time, so the "
                    f"reduction's base value is timing-dependent",
                    rank=r, chunk=c, round_=k)


#: collectives with a postcondition model; programs for anything else
#: are rejected at verify time (they could never be proven)
VERIFIABLE_COLLS = frozenset((CollType.ALLREDUCE, CollType.ALLGATHER,
                              CollType.REDUCE_SCATTER, CollType.BCAST))

#: collectives with no reduction operator: REDUCE ops are structurally
#: invalid in their programs
NON_REDUCING_COLLS = frozenset((CollType.ALLGATHER, CollType.BCAST))


def _initial_state(prog: Program) -> List[List[Optional[_Val]]]:
    """Per-(rank, chunk) symbolic start state; ``None`` = undefined
    (no data there yet)."""
    n, nch = prog.nranks, prog.nchunks
    coll = prog.coll
    if coll in (CollType.ALLREDUCE, CollType.REDUCE_SCATTER):
        return [[frozenset((r,)) for _ in range(nch)] for r in range(n)]
    if coll == CollType.ALLGATHER:
        if nch % n != 0:
            raise VerifyError(
                f"allgather programs need nchunks divisible by nranks "
                f"(got {nch} chunks for {n} ranks) — chunk ownership is "
                f"part of the collective contract")
        m = nch // n
        return [[frozenset((r,)) if c // m == r else None
                 for c in range(nch)] for r in range(n)]
    if coll == CollType.BCAST:
        # generated for root 0; the compiler rotates ranks per post
        return [[frozenset((0,)) if r == 0 else None
                 for _ in range(nch)] for r in range(n)]
    raise VerifyError(
        f"no postcondition model for {coll!r}: the verifier proves "
        f"{sorted(c.name.lower() for c in VERIFIABLE_COLLS)} programs")


def _check_postcondition(prog: Program,
                         state: List[List[Optional[_Val]]]) -> None:
    """Compare the final symbolic state against the collective's
    contract; raises naming the first offending (rank, chunk)."""
    n, nch = prog.nranks, prog.nchunks
    full = frozenset(range(n))

    def fail(r: int, c: int, want: _Val) -> None:
        got = state[r][c]
        if got is None:
            raise VerifyError(
                f"postcondition violated: final buffer is undefined "
                f"(no data ever delivered), expected contribution(s) "
                f"from rank(s) {sorted(want)}", rank=r, chunk=c)
        missing = sorted(want - got)
        extra = sorted(got - want)
        detail = []
        if missing:
            detail.append(f"missing contributions from rank(s) {missing}")
        if extra:
            detail.append(f"unexpected contributions from rank(s) {extra}")
        raise VerifyError(
            f"postcondition violated: final buffer holds {sorted(got)}, "
            f"expected {sorted(want)} ({'; '.join(detail)})",
            rank=r, chunk=c)

    if prog.coll == CollType.ALLREDUCE:
        for r in range(n):
            for c in range(nch):
                if state[r][c] != full:
                    fail(r, c, full)
    elif prog.coll == CollType.REDUCE_SCATTER:
        # only the owned block is the contract; the rest is scratch
        if nch % n != 0:
            raise VerifyError(
                f"reduce_scatter programs need nchunks divisible by "
                f"nranks (got {nch} chunks for {n} ranks)")
        for r in range(n):
            for c in prog.block_chunks(r):
                if state[r][c] != full:
                    fail(r, c, full)
    elif prog.coll == CollType.ALLGATHER:
        m = nch // n
        for r in range(n):
            for c in range(nch):
                want = frozenset((c // m,))
                if state[r][c] != want:
                    fail(r, c, want)
    elif prog.coll == CollType.BCAST:
        want = frozenset((0,))
        for r in range(n):
            for c in range(nch):
                if state[r][c] != want:
                    fail(r, c, want)


def verify(prog: Program) -> None:
    """Verify *prog*; raises :class:`VerifyError` on the first failure.

    Checks, in order: structural sanity (uniform rounds, REDUCE bans
    for non-reducing collectives, at most one edge-wire precision),
    1:1 matching, deadlock-freedom, chunk + wire consistency (a wire
    op's chunk and precision must equal the matched side's), reduce
    disjointness/definedness, and the collective postcondition.
    """
    n, R = prog.nranks, prog.n_rounds
    if prog.coll not in VERIFIABLE_COLLS:
        raise VerifyError(
            f"no postcondition model for {prog.coll!r}: the verifier "
            f"proves {sorted(c.name.lower() for c in VERIFIABLE_COLLS)} "
            f"programs")
    if len(prog.ranks) != n:
        raise VerifyError(f"program has {len(prog.ranks)} rank streams "
                          f"for nranks={n}")
    wires = set()
    for r, rp in enumerate(prog.ranks):
        if len(rp.rounds) != R:
            raise VerifyError(
                f"non-uniform round count ({len(rp.rounds)} != {R})",
                rank=r)
        for k, ops in enumerate(rp.rounds):
            for op in ops:
                if op.kind in (OpKind.REDUCE, OpKind.PUT_RED) and \
                        prog.coll in NON_REDUCING_COLLS:
                    raise VerifyError(
                        f"{op.describe()} in a "
                        f"{prog.coll.name.lower()} program — this "
                        f"collective has no reduction operator",
                        rank=r, chunk=op.chunk, round_=k)
                if op.wire and op.kind not in PUT_KINDS:
                    wires.add(op.wire)
    if len(wires) > 1:
        raise VerifyError(
            f"mixed per-edge wire precisions {sorted(wires)} — the "
            f"executor runs one codec per program")
    if wires and prog.wire:
        raise VerifyError(
            "program-level wire precision combined with per-edge wire "
            "tags — use one or the other")
    # _collect_puts enforces the window-group invariants as it derives
    # the delivery lists; the groups themselves are executor detail
    _put_groups, incoming_puts = _collect_puts(prog)
    _check_round_hazards(prog, incoming_puts)
    matches = _match_ops(prog)
    for (sender, recver) in matches.values():
        p, ks, sop = sender
        q, kr, rop = recver
        if sop.chunk != rop.chunk:
            raise VerifyError(
                f"chunk mismatch across the wire: {sop.describe()} on "
                f"rank {p} (round {ks}) delivers into {rop.describe()} "
                f"— contributions are per-slice, so sender and receiver "
                f"must name the same chunk", rank=q, chunk=rop.chunk,
                round_=kr)
        if sop.wire != rop.wire:
            raise VerifyError(
                f"wire-precision mismatch across the wire: "
                f"{sop.describe()} on rank {p} (round {ks}) delivers "
                f"into {rop.describe()} — sender and receiver must "
                f"agree on the edge codec or the byte counts differ",
                rank=q, chunk=rop.chunk, round_=kr)
    order = _topo_rounds(prog, matches, incoming_puts)

    # ------------------------------------------------------------------
    # symbolic execution in wait-graph topological order
    state: List[List[Optional[_Val]]] = _initial_state(prog)
    sendval: Dict[Tuple[int, int, int], Optional[_Val]] = {}  # (src,dst,slot)
    putval: Dict[Tuple[int, int], Optional[_Val]] = {}        # (src,slot)

    def snapshot_sends(r: int, k: int) -> None:
        """Record send/put values of round *k* of rank *r* (the state
        the posts observe: after round k-1 completed, before round k's
        own deliveries). Puts snapshot per window — (sender, slot) —
        since every target of a fan-out put reads the one cell."""
        if k >= R:
            return
        for op in prog.ranks[r].rounds[k]:
            if op.kind == OpKind.SEND:
                sendval[(r, op.peer, op.slot)] = state[r][op.chunk]
            elif op.kind in PUT_KINDS:
                putval[(r, op.slot)] = state[r][op.chunk]

    for r in range(n):
        snapshot_sends(r, 0)
    for (r, k) in order:
        # deliveries first (wire ops), then local copies — the executor
        # applies the same order
        for op in prog.ranks[r].rounds[k]:
            if op.kind == OpKind.RECV:
                state[r][op.chunk] = sendval[(op.peer, r, op.slot)]
            elif op.kind == OpKind.REDUCE:
                incoming = sendval[(op.peer, r, op.slot)]
                cur = state[r][op.chunk]
                if incoming is None or cur is None:
                    which = "incoming" if incoming is None else "local"
                    raise VerifyError(
                        f"{op.describe()} reduces UNDEFINED data (the "
                        f"{which} chunk never received a value) — the "
                        f"result would be garbage", rank=r,
                        chunk=op.chunk, round_=k)
                dup = incoming & cur
                if dup:
                    raise VerifyError(
                        f"contribution of rank(s) "
                        f"{sorted(dup)} reduced twice by "
                        f"{op.describe()} — the reduction would "
                        f"double-count them", rank=r, chunk=op.chunk,
                        round_=k)
                state[r][op.chunk] = cur | incoming
        # one-sided put deliveries, in the executor's order: overwrites
        # first, then reductions, each in (sender, slot) order
        deliveries = incoming_puts.get((r, k), ())
        for p, op in deliveries:
            if op.kind == OpKind.PUT:
                state[r][op.chunk] = putval[(p, op.slot)]
        for p, op in deliveries:
            if op.kind == OpKind.PUT_RED:
                inc_val = putval[(p, op.slot)]
                cur = state[r][op.chunk]
                if inc_val is None or cur is None:
                    which = "incoming" if inc_val is None else "local"
                    raise VerifyError(
                        f"{op.describe()} (from rank {p}) reduces "
                        f"UNDEFINED data (the {which} chunk never "
                        f"received a value) — the result would be "
                        f"garbage", rank=r, chunk=op.chunk, round_=k)
                dup = inc_val & cur
                if dup:
                    raise VerifyError(
                        f"contribution of rank(s) {sorted(dup)} "
                        f"reduced twice by {op.describe()} (from rank "
                        f"{p}) — the reduction would double-count "
                        f"them", rank=r, chunk=op.chunk, round_=k)
                state[r][op.chunk] = cur | inc_val
        for op in prog.ranks[r].rounds[k]:
            if op.kind == OpKind.COPY:
                state[r][op.chunk] = state[r][op.src_chunk]
        snapshot_sends(r, k + 1)

    _check_postcondition(prog, state)
