"""Built-in program families — parameterized generators (the port's copy
of ``ucc_tpu/dsl/families.py``; the same programs, op for op).

Each generator produces a verified-shape :class:`~.ir.Program` for one
concrete team size (or raises :class:`Inapplicable` when the parameter
does not fit that size, e.g. a radix that does not divide the team).
The registry sweeps each family's parameter grid, verifies every
program, and registers the survivors as score-map candidates — so a new
variant is a new *parameter*, not a new hand-written algorithm.

Families:

``ring(chunks=m)``
    The bandwidth allreduce ring (reduce-scatter ring + allgather ring)
    with each rank-block split into ``m`` wire chunks: ``m=1`` is the
    classic hand-written ring; higher ``m`` moves the same bytes as
    more, smaller messages per hop (transport-pipelining the copy-free
    matcher can overlap).

``rhd(radix=r)``
    Recursive halving/doubling — the SRA structure at radix ``r``:
    reduce-scatter by recursive vector splitting, allgather by replaying
    the splits in reverse. Needs ``n == r^k``. ``r == n`` degenerates to
    the DIRECT exchange (one reduce-scatter round + one allgather round
    with n-1 concurrent messages) — applicable at every team size.

``sra_pipe(depth=d)``
    The rhd program per vector fragment, driven through the pipelined
    schedule with ``d`` total fragments — fragment k+1's
    reduce-scatter overlaps fragment k's allgather (the
    ALLREDUCE_SRA_KN_PIPELINE role, generated).

``qdirect``
    Fused allreduce+quantize: the direct (radix = n) program with the
    block-scaled codec (``quant``) inserted at every send edge — each value is
    quantized once per phase, the same (n + 1) half-step error model as
    the hand-written ``q<mode>_sra``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..constants import CollType
from .ir import Program, ProgramBuilder


class Inapplicable(Exception):
    """The (family, param) pair cannot target this team size."""


def _part(lo: int, hi: int, r: int, t: int) -> Tuple[int, int]:
    n = hi - lo
    return lo + (t * n) // r, lo + ((t + 1) * n) // r


# ---------------------------------------------------------------------------
# ring(chunks=m)
# ---------------------------------------------------------------------------

def gen_ring(n: int, chunks: int = 1) -> Program:
    """Allreduce ring over ``n * chunks`` chunks; block ``b`` of the
    vector is chunks ``[b*chunks, (b+1)*chunks)``."""
    m = int(chunks)
    if n < 2:
        raise Inapplicable(f"ring needs >= 2 ranks (got {n})")
    if m < 1:
        raise Inapplicable(f"ring chunking must be >= 1 (got {m})")
    b = ProgramBuilder("ring", CollType.ALLREDUCE, n, n * m,
                       params={"chunks": m})

    def chunks_of(block: int) -> List[int]:
        return list(range(block * m, (block + 1) * m))

    # phase 1: reduce-scatter ring
    for step in range(n - 1):
        b.next_round()
        for me in range(n):
            right = (me + 1) % n
            left = (me - 1) % n
            sb = (me - 1 - step) % n
            rb = (me - 2 - step) % n
            for c in chunks_of(sb):
                b.send(me, c, to=right)
            for c in chunks_of(rb):
                b.reduce(me, c, frm=left)
    # phase 2: allgather ring
    for step in range(n - 1):
        b.next_round()
        for me in range(n):
            right = (me + 1) % n
            left = (me - 1) % n
            sb = (me - step) % n
            rb = (me - step - 1) % n
            for c in chunks_of(sb):
                b.send(me, c, to=right)
            for c in chunks_of(rb):
                b.recv(me, c, frm=left)
    return b.build(f"gen_ring_c{m}")


# ---------------------------------------------------------------------------
# rhd(radix=r)
# ---------------------------------------------------------------------------

def _rhd_levels(n: int, r: int) -> List[int]:
    """Distances of the recursive split, outermost first; raises
    Inapplicable unless n == r^k (k >= 1)."""
    if n < 2:
        raise Inapplicable(f"rhd needs >= 2 ranks (got {n})")
    if r < 2 or r > n:
        raise Inapplicable(f"radix {r} out of range [2, {n}]")
    dists = []
    full = 1
    while full < n:
        full *= r
    if full != n:
        raise Inapplicable(f"team size {n} is not a power of radix {r}")
    dist = n // r
    while dist >= 1:
        dists.append(dist)
        dist //= r
    return dists


def gen_rhd(n: int, radix: int = 2, wire: str = "") -> Program:
    """Recursive halving/doubling allreduce at radix ``radix`` over
    ``n`` chunks (one per rank-block). ``wire`` tags the program for
    quantized send edges (the qdirect family passes it)."""
    r = int(radix)
    dists = _rhd_levels(n, r)
    family = "qdirect" if wire else "rhd"
    if wire:
        # the search proposes quantized rhd at non-direct radices too;
        # those need distinct names (the grid's qdirect stays r == n)
        name = f"gen_q{wire}_direct" if r == n else f"gen_q{wire}_rhd_r{r}"
    else:
        name = f"gen_rhd_r{r}"
    b = ProgramBuilder(family, CollType.ALLREDUCE, n, n,
                       params={"radix": r}, wire=wire)

    # per-rank segment walk is pure, so precompute each rank's (lo, hi)
    # at every level
    def seg_walk(me: int) -> List[Tuple[int, int]]:
        lo, hi = 0, n
        segs = [(lo, hi)]
        for dist in dists:
            lo, hi = _part(lo, hi, r, (me // dist) % r)
            segs.append((lo, hi))
        return segs

    walks = [seg_walk(me) for me in range(n)]

    # phase 1: reduce-scatter by recursive splitting
    for lvl, dist in enumerate(dists):
        b.next_round()
        for me in range(n):
            lo, hi = walks[me][lvl]
            d = (me // dist) % r
            base = me - d * dist
            keep = _part(lo, hi, r, d)
            for t in range(r):
                if t == d:
                    continue
                peer = base + t * dist
                give = _part(lo, hi, r, t)
                for c in range(give[0], give[1]):
                    b.send(me, c, to=peer)
                for c in range(keep[0], keep[1]):
                    b.reduce(me, c, frm=peer)
    # phase 2: allgather by replaying the splits in reverse
    for lvl in range(len(dists) - 1, -1, -1):
        dist = dists[lvl]
        b.next_round()
        for me in range(n):
            lo, hi = walks[me][lvl]
            d = (me // dist) % r
            base = me - d * dist
            mine = walks[me][lvl + 1]
            for t in range(r):
                if t == d:
                    continue
                peer = base + t * dist
                theirs = _part(lo, hi, r, t)
                for c in range(mine[0], mine[1]):
                    b.send(me, c, to=peer)
                for c in range(theirs[0], theirs[1]):
                    b.recv(me, c, frm=peer)
    return b.build(name)


def gen_qdirect(n: int, mode: str) -> Program:
    """Fused allreduce+quantize: the direct (radix = n) exchange with
    the ``mode`` codec at every send edge."""
    if mode not in ("int8", "fp8"):
        raise Inapplicable(f"unknown wire precision '{mode}'")
    return gen_rhd(n, radix=n, wire=mode)


# ---------------------------------------------------------------------------
# sra(radix=r) — the hand-written SRA structure at ANY team size
# ---------------------------------------------------------------------------

def gen_sra(n: int, radix: int = 2) -> Program:
    """The hand-written ``sra_knomial`` allreduce as an IR program: the
    radix-``r`` recursive halving/doubling core over ``full = r^k <= n``
    ranks, with the extra/proxy fold for the remainder — extras hand
    their whole vector to proxy ``e % full`` in round 0 and receive the
    final result back in the last round (the
    coll_patterns/recursive_knomial.h extra distribution). ``n == r^k``
    degenerates to plain :func:`gen_rhd`. This is the bridge program the
    native-plan path runs when the hand-written SRA candidate is
    selected (tl/host/sra.py), verified like any family."""
    if n < 2:
        raise Inapplicable(f"sra needs >= 2 ranks (got {n})")
    r = max(2, min(int(radix), n))
    full = 1
    while full * r <= n:
        full *= r
    if full < 2:
        full = n          # r > n clamp left full == 1: direct exchange
        r = n
    if full == n:
        prog = gen_rhd(n, radix=r)
        prog.family = "sra"
        prog.params = {"radix": r}
        prog.name = f"gen_sra_r{r}"
        return prog

    dists = _rhd_levels(full, r)
    b = ProgramBuilder("sra", CollType.ALLREDUCE, n, full,
                       params={"radix": r})

    def seg_walk(me: int) -> List[Tuple[int, int]]:
        lo, hi = 0, full
        segs = [(lo, hi)]
        for dist in dists:
            lo, hi = _part(lo, hi, r, (me // dist) % r)
            segs.append((lo, hi))
        return segs

    walks = [seg_walk(me) for me in range(full)]

    # round 0: extras fold their whole vector into the proxy
    b.next_round()
    for e in range(full, n):
        proxy = e % full
        for c in range(full):
            b.send(e, c, to=proxy)
            b.reduce(proxy, c, frm=e)
    # rhd core among [0, full): reduce-scatter then allgather
    for lvl, dist in enumerate(dists):
        b.next_round()
        for me in range(full):
            lo, hi = walks[me][lvl]
            d = (me // dist) % r
            base = me - d * dist
            keep = _part(lo, hi, r, d)
            for t in range(r):
                if t == d:
                    continue
                peer = base + t * dist
                give = _part(lo, hi, r, t)
                for c in range(give[0], give[1]):
                    b.send(me, c, to=peer)
                for c in range(keep[0], keep[1]):
                    b.reduce(me, c, frm=peer)
    for lvl in range(len(dists) - 1, -1, -1):
        dist = dists[lvl]
        b.next_round()
        for me in range(full):
            lo, hi = walks[me][lvl]
            d = (me // dist) % r
            base = me - d * dist
            mine = walks[me][lvl + 1]
            for t in range(r):
                if t == d:
                    continue
                peer = base + t * dist
                theirs = _part(lo, hi, r, t)
                for c in range(mine[0], mine[1]):
                    b.send(me, c, to=peer)
                for c in range(theirs[0], theirs[1]):
                    b.recv(me, c, frm=peer)
    # last round: proxies unfold the full result to their extras
    b.next_round()
    for e in range(full, n):
        proxy = e % full
        for c in range(full):
            b.send(proxy, c, to=e)
            b.recv(e, c, frm=proxy)
    return b.build(f"gen_sra_r{r}")


# ---------------------------------------------------------------------------
# sra_pipe(depth=d) — fragment program + pipeline metadata
# ---------------------------------------------------------------------------

def sra_pipe_fragment(n: int, depth: int,
                      radix: Optional[int] = None) -> Program:
    """The per-fragment program of the pipelined SRA family: rhd at
    radix 2 when the team is a power of two (the canonical SRA halving
    instance), else the direct exchange. ``depth`` (>= 2) is pipeline
    metadata consumed by the compiler (PipelinedSchedule fragment
    count), not part of the dataflow itself — it is folded into the
    program's params/name so each depth is a distinct tuner candidate.
    An explicit ``radix`` (the search's JOINT depth x radix space) runs
    the SRA structure at that radix instead — applicable at any team
    size via the extra/proxy fold — and names the variant
    ``gen_sra_pipe_d{d}r{r}``."""
    d = int(depth)
    if d < 2:
        raise Inapplicable(f"pipeline depth must be >= 2 (got {d})")
    if radix:
        prog = gen_sra(n, radix=int(radix))
        prog.family = "sra_pipe"
        prog.params = {"depth": d, "radix": int(radix)}
        prog.name = f"gen_sra_pipe_d{d}r{int(radix)}"
        return prog
    rdx = 2 if n >= 2 and (n & (n - 1)) == 0 else n
    prog = gen_rhd(n, radix=rdx)
    prog.family = "sra_pipe"
    prog.params = {"depth": d, "radix": rdx}
    prog.name = f"gen_sra_pipe_d{d}"
    return prog


# ---------------------------------------------------------------------------
# pooled(chunks=m) — one-sided put+flag allreduce over arena windows
# ---------------------------------------------------------------------------

def gen_pooled(n: int, chunks: int = 1) -> Program:
    """Pooled-window allreduce (the ipc TL's one-sided tier): two
    rounds of one-sided puts through process-shared arena windows, no
    two-sided matching at all.

    Round 0: every rank PUT_REDs each foreign chunk into its owner's
    window set (owner of chunk ``c`` is rank ``c // m``); the owner
    reduces the ``n-1`` contributions into its own copy in
    deterministic source order. Round 1: each owner PUTs the fully
    reduced chunk back to every other rank — one window per
    (owner, chunk), read by all ``n-1`` targets (the fan-out put).
    2 rounds total regardless of team size: the direct exchange's
    round count with none of its matcher traffic — latency is two
    flag handoffs, bandwidth is two memcpys per chunk each way.

    ``chunks=m`` splits each owner block into ``m`` cells (more,
    smaller windows — the transport-pipelining knob the ring families
    use). Only teams whose transport exposes a shared-memory arena
    (tl/ipc) can run this; the compiled task raises NOT_SUPPORTED
    everywhere else and the fallback walk picks a two-sided program.
    """
    m = int(chunks)
    if n < 2:
        raise Inapplicable(f"pooled needs >= 2 ranks (got {n})")
    if m < 1:
        raise Inapplicable(f"pooled chunking must be >= 1 (got {m})")
    b = ProgramBuilder("pooled", CollType.ALLREDUCE, n, n * m,
                       params={"chunks": m})
    b.next_round()
    for me in range(n):
        for c in range(n * m):
            owner = c // m
            if owner != me:
                b.put_red(me, c, to=owner)
    b.next_round()
    for owner in range(n):
        for c in range(owner * m, (owner + 1) * m):
            for peer in range(n):
                if peer != owner:
                    b.put(owner, c, to=peer)
    return b.build(f"gen_pooled_c{m}")


# ---------------------------------------------------------------------------
# allgather families (the IR beyond allreduce)
# ---------------------------------------------------------------------------

def gen_ag_ring(n: int, chunks: int = 1) -> Program:
    """Allgather ring (the gen_ring phase-2 structure standalone):
    block ``b`` of the vector is chunks ``[b*chunks, (b+1)*chunks)``,
    owned by rank ``b`` at entry."""
    m = int(chunks)
    if n < 2:
        raise Inapplicable(f"ag_ring needs >= 2 ranks (got {n})")
    if m < 1:
        raise Inapplicable(f"ag_ring chunking must be >= 1 (got {m})")
    b = ProgramBuilder("ag_ring", CollType.ALLGATHER, n, n * m,
                       params={"chunks": m})
    for step in range(n - 1):
        b.next_round()
        for me in range(n):
            right = (me + 1) % n
            left = (me - 1) % n
            sb = (me - step) % n
            rb = (me - step - 1) % n
            for c in range(sb * m, (sb + 1) * m):
                b.send(me, c, to=right)
            for c in range(rb * m, (rb + 1) * m):
                b.recv(me, c, frm=left)
    return b.build(f"gen_ag_ring_c{m}")


def gen_ag_rd(n: int, radix: int = 2) -> Program:
    """Recursive-doubling allgather at radix ``r`` (needs ``n == r^k``;
    ``r == n`` degenerates to the one-round direct exchange, applicable
    at every team size). At each level every rank trades its whole
    accumulated block set with the ``r-1`` partners of its digit group —
    ``n-1`` blocks received total, log_r(n) rounds."""
    r = int(radix) or n
    if n < 2:
        raise Inapplicable(f"ag_rd needs >= 2 ranks (got {n})")
    if r < 2 or r > n:
        raise Inapplicable(f"radix {r} out of range [2, {n}]")
    full = 1
    while full < n:
        full *= r
    if full != n:
        raise Inapplicable(f"team size {n} is not a power of radix {r}")
    b = ProgramBuilder("ag_rd", CollType.ALLGATHER, n, n,
                       params={"radix": r})
    held: List[List[int]] = [[me] for me in range(n)]
    d = 1
    while d < n:
        b.next_round()
        nxt: List[List[int]] = [None] * n  # type: ignore[list-item]
        for me in range(n):
            digit = (me // d) % r
            base = me - digit * d
            acc = list(held[me])
            for t in range(r):
                if t == digit:
                    continue
                peer = base + t * d
                for c in held[me]:
                    b.send(me, c, to=peer)
                for c in held[peer]:
                    b.recv(me, c, frm=peer)
                acc.extend(held[peer])
            nxt[me] = sorted(acc)
        held = nxt
        d *= r
    name = f"gen_ag_rd_r{r}" if r != n else "gen_ag_direct"
    return b.build(name)


# ---------------------------------------------------------------------------
# reduce_scatter families
# ---------------------------------------------------------------------------

def gen_rs_ring(n: int, chunks: int = 1) -> Program:
    """Reduce-scatter ring (the gen_ring phase-1 structure standalone):
    after ``n-1`` rounds rank ``b`` holds the full reduction of block
    ``b``."""
    m = int(chunks)
    if n < 2:
        raise Inapplicable(f"rs_ring needs >= 2 ranks (got {n})")
    if m < 1:
        raise Inapplicable(f"rs_ring chunking must be >= 1 (got {m})")
    b = ProgramBuilder("rs_ring", CollType.REDUCE_SCATTER, n, n * m,
                       params={"chunks": m})
    for step in range(n - 1):
        b.next_round()
        for me in range(n):
            right = (me + 1) % n
            left = (me - 1) % n
            sb = (me - 1 - step) % n
            rb = (me - 2 - step) % n
            for c in range(sb * m, (sb + 1) * m):
                b.send(me, c, to=right)
            for c in range(rb * m, (rb + 1) * m):
                b.reduce(me, c, frm=left)
    return b.build(f"gen_rs_ring_c{m}")


def gen_rs_direct(n: int) -> Program:
    """Direct reduce-scatter: one round, every rank ships each foreign
    block straight to its owner and reduces the ``n-1`` incoming copies
    of its own block."""
    if n < 2:
        raise Inapplicable(f"rs_direct needs >= 2 ranks (got {n})")
    b = ProgramBuilder("rs_direct", CollType.REDUCE_SCATTER, n, n,
                       params={})
    b.next_round()
    for me in range(n):
        for blk in range(n):
            if blk == me:
                continue
            b.send(me, blk, to=blk)
            b.reduce(me, me, frm=blk)
    return b.build("gen_rs_direct")


# ---------------------------------------------------------------------------
# bcast families (root 0 — the compiler rotates ranks for other roots)
# ---------------------------------------------------------------------------

def gen_bc_kn(n: int, radix: int = 2) -> Program:
    """K-nomial tree bcast at radix ``r`` (the BcastKnomial structure as
    an IR program; ``radix == 0``/``n`` is the one-round linear fan-out).
    Round ``t`` handles tree distance ``r^(k-1-t)``."""
    r = int(radix) or n
    if n < 2:
        raise Inapplicable(f"bc_kn needs >= 2 ranks (got {n})")
    if r < 2 or r > n:
        raise Inapplicable(f"radix {r} out of range [2, {n}]")
    k = 0
    cap = 1
    while cap < n:
        cap *= r
        k += 1

    def tree_level(v: int) -> int:
        f = 0
        while v % (r ** (f + 1)) == 0:
            f += 1
        return f

    b = ProgramBuilder("bc_kn", CollType.BCAST, n, 1, params={"radix": r})
    for i in range(k - 1, -1, -1):       # round t = k-1-i, dist = r^i
        b.next_round()
        dist = r ** i
        for v in range(n):
            f = tree_level(v) if v != 0 else k
            if v != 0 and i == f:
                j = (v // dist) % r
                b.recv(v, 0, frm=v - j * dist)
            elif i < f:
                for j in range(1, r):
                    child = v + j * dist
                    if child < n:
                        b.send(v, 0, to=child)
    name = f"gen_bc_kn_r{r}" if r != n else "gen_bc_linear"
    return b.build(name)


def gen_bc_chain(n: int, chunks: int = 2) -> Program:
    """Chunk-pipelined chain bcast: rank ``i`` receives chunk ``c`` from
    ``i-1`` in round ``i-1+c`` and forwards it to ``i+1`` in the next
    round — ``n+chunks-2`` rounds total, wire-pipelined so the chain's
    latency is paid once, not per byte."""
    m = int(chunks)
    if n < 2:
        raise Inapplicable(f"bc_chain needs >= 2 ranks (got {n})")
    if m < 1:
        raise Inapplicable(f"bc_chain chunking must be >= 1 (got {m})")
    b = ProgramBuilder("bc_chain", CollType.BCAST, n, m,
                       params={"chunks": m})
    n_rounds = n + m - 2
    for t in range(n_rounds):
        b.next_round()
        for me in range(n):
            if me + 1 < n:
                c = t - me
                if 0 <= c < m:
                    b.send(me, c, to=me + 1)
            if me > 0:
                c = t - (me - 1)
                if 0 <= c < m:
                    b.recv(me, c, frm=me - 1)
    return b.build(f"gen_bc_chain_c{m}")


# ---------------------------------------------------------------------------
# hier — composed hierarchical allreduce along a topology tree
# ---------------------------------------------------------------------------

def gen_hier(paths: List[tuple], top: int = 2, wire: str = "",
             chunks: int = 1) -> Program:
    """HiCCL-style composed hierarchical allreduce over a topology tree:
    reduce up the tree level by level, run a
    per-level allreduce program among the top leaders, broadcast the
    result back down — one flat verified Program over the whole team.

    ``paths`` is the per-rank attribute path list the
    :class:`~..topo.topo.HierTree` is built from (e.g.
    ``(pod_hash, host_hash)``); ``top`` picks the leaders' algorithm:
    ``0`` = direct exchange, ``1`` = ring (with ``chunks`` wire chunks
    per block), ``r >= 2`` = the SRA structure at radix ``r`` (any
    leader count). ``wire`` quantizes the DCN-class edges — every edge
    whose endpoints sit in different pods (different ``paths[..][0]``;
    on podless 2-level trees, the inter-node leader edges) — while all
    intra-node/intra-pod edges stay exact; senders re-decode their own
    copy at every quantized edge, so all ranks still end bitwise
    identical.
    """
    n = len(paths)
    if n < 2:
        raise Inapplicable(f"hier needs >= 2 ranks (got {n})")
    from ..topo.topo import HierTree
    tree = HierTree(list(paths), 0)
    L = tree.n_levels
    if len(tree.levels[0].groups) < 2:
        raise Inapplicable("hier needs >= 2 level-0 groups (single-node "
                           "teams are served by the flat families)")
    T = tree.levels[L - 1].groups[0]
    depth = len(paths[0])

    def edge_wire(a: int, bb: int) -> str:
        if not wire:
            return ""
        if depth >= 2:
            return wire if paths[a][0] != paths[bb][0] else ""
        # podless tree: the inter-NODE leader edges are the slow class;
        # same-node edges (reduce-up/bcast-down inside a group) stay
        # exact like every other ICI-class edge
        return wire if paths[a] != paths[bb] else ""

    top_code = int(top)
    sub: Optional[Program] = None
    if len(T) >= 2:
        if top_code == 0:
            sub = gen_rhd(len(T), radix=len(T))
        elif top_code == 1:
            sub = gen_ring(len(T), chunks=max(1, int(chunks)))
        else:
            sub = gen_sra(len(T), radix=top_code)
    nch = sub.nchunks if sub is not None else 1
    # canonicalize by the EFFECTIVE top structure: on a 2-leader top
    # group, sra radix 4, sra radix 2 and the direct exchange all
    # collapse to the same 2-rank program — one candidate, not three
    # rotation slots whose measured differences are pure noise
    if sub is not None:
        if sub.family == "ring":
            eff = {"top": 1, "chunks": int(sub.params["chunks"])}
            eff_name = f"ring_c{sub.params['chunks']}"
        elif sub.params.get("radix") == len(T):
            eff = {"top": 0}
            eff_name = "direct"
        else:
            eff = {"top": int(sub.params["radix"])}
            eff_name = f"sra_r{sub.params['radix']}"
    else:
        eff = {"top": 0}
        eff_name = "direct"
    params: Dict[str, int] = dict(eff)
    if wire:
        params["wire"] = wire       # type: ignore[assignment]
    b = ProgramBuilder("hier", CollType.ALLREDUCE, n, nch, params=params)

    # phase 1: reduce up the tree (levels 0 .. L-2)
    for lvl in range(L - 1):
        groups = [g for g in tree.levels[lvl].groups if len(g) > 1]
        if not groups:
            continue
        b.next_round()
        for g in groups:
            leader = g[0]
            for mbr in g[1:]:
                w = edge_wire(mbr, leader)
                for c in range(nch):
                    b.send(mbr, c, to=leader, wire=w)
                    b.reduce(leader, c, frm=mbr, wire=w)
    # phase 2: the top leaders' own allreduce, ranks translated
    if sub is not None:
        from .ir import OpKind
        for k in range(sub.n_rounds):
            b.next_round()
            for i in range(sub.nranks):
                me = T[i]
                for op in sub.ranks[i].rounds[k]:
                    if op.kind == OpKind.COPY:
                        b.copy(me, op.chunk, op.src_chunk)
                        continue
                    peer = T[op.peer]
                    w = edge_wire(me, peer)
                    if op.kind == OpKind.SEND:
                        b.send(me, op.chunk, to=peer, wire=w)
                    elif op.kind == OpKind.RECV:
                        b.recv(me, op.chunk, frm=peer, wire=w)
                    else:
                        b.reduce(me, op.chunk, frm=peer, wire=w)
    # phase 3: broadcast back down (levels L-2 .. 0)
    for lvl in range(L - 2, -1, -1):
        groups = [g for g in tree.levels[lvl].groups if len(g) > 1]
        if not groups:
            continue
        b.next_round()
        for g in groups:
            leader = g[0]
            for mbr in g[1:]:
                w = edge_wire(leader, mbr)
                for c in range(nch):
                    b.send(leader, c, to=mbr, wire=w)
                    b.recv(mbr, c, frm=leader, wire=w)
    name = f"gen_hier_{eff_name}"
    if wire:
        name += f"_q{wire}"
    return b.build(name)


# ---------------------------------------------------------------------------
# default parameter grids (the registry/ucc_tune sweep space)
# ---------------------------------------------------------------------------

DEFAULT_GRIDS: Dict[str, List[int]] = {
    "ring": [1, 2, 4],
    "rhd": [2, 4, 8, 0],       # 0 = radix n (the direct exchange)
    "sra_pipe": [2, 4],
    "qdirect": [0],            # parameterized by UCC_QUANT, not a grid
    "ag_ring": [1, 2],
    "ag_rd": [2, 4, 0],        # 0 = radix n (the direct exchange)
    "rs_ring": [1, 2],
    "rs_direct": [0],
    "bc_kn": [2, 4, 0],        # 0 = radix n (linear fan-out)
    "bc_chain": [2, 4],
    "hier": [2, 0],            # top algorithm: sra radix / 0 = direct
    "pooled": [1, 2],          # window cells per owner block (ipc TL)
}

#: the collective each family serves (registration + search routing)
FAMILY_COLL: Dict[str, CollType] = {
    "ring": CollType.ALLREDUCE,
    "rhd": CollType.ALLREDUCE,
    "sra_pipe": CollType.ALLREDUCE,
    "qdirect": CollType.ALLREDUCE,
    "sra": CollType.ALLREDUCE,
    "hier": CollType.ALLREDUCE,
    "pooled": CollType.ALLREDUCE,
    "ag_ring": CollType.ALLGATHER,
    "ag_rd": CollType.ALLGATHER,
    "rs_ring": CollType.REDUCE_SCATTER,
    "rs_direct": CollType.REDUCE_SCATTER,
    "bc_kn": CollType.BCAST,
    "bc_chain": CollType.BCAST,
}

FAMILY_NAMES = tuple(DEFAULT_GRIDS)
