"""Double binary tree (DBT) algorithms.

Ports the semantics of UCC's src/components/tl/ucp/
coll_patterns/double_binary_tree.h:15-25 and its users
(bcast/bcast_dbt.c, reduce/reduce_dbt.c, allreduce via DBT): the message
splits in half and the halves flow through two complementary binary trees
built over the non-root ranks — tree2 is the mirror of tree1, so a rank
that is interior in one tree tends to be a leaf in the other, roughly
doubling usable bandwidth vs a single tree while keeping O(log N) depth.

Tree 1 is the in-order binary search tree over virtual ranks; tree 2 is
its mirror. Both trees run concurrently inside one generator (recvs posted
up front, forwarding as halves arrive).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ...constants import ReductionOp
from ...ec.cpu import reduce_arrays, storage_dtype
from ..base import binfo_typed
from .task import HostCollTask


def inorder_tree(m: int) -> Tuple[Optional[int], Dict[int, Optional[int]],
                                  Dict[int, List[int]]]:
    """In-order BST over [0, m): (root, parent map, children map)."""
    parent: Dict[int, Optional[int]] = {}
    children: Dict[int, List[int]] = {i: [] for i in range(m)}
    if m == 0:
        return None, parent, children

    def build(lo: int, hi: int, par: Optional[int]) -> None:
        if lo >= hi:
            return
        mid = (lo + hi) // 2
        parent[mid] = par
        if par is not None:
            children[par].append(mid)
        build(lo, mid, mid)
        build(mid + 1, hi, mid)

    build(0, m, None)
    root = (0 + m) // 2
    return root, parent, children


class _DbtBase(HostCollTask):
    def _setup(self):
        args = self.args
        self.root = int(args.root)
        self.count = int((args.src or args.dst).count)
        self.dt = (args.src or args.dst).datatype
        p = self.gsize
        m = p - 1
        t1_root, t1_parent, t1_children = inorder_tree(m)
        self.trees = []
        for t in range(2):
            if t == 0:
                rootv, par, ch = t1_root, t1_parent, t1_children
            else:
                # mirror: node i of tree2 == tree1 node (m-1-i)
                rootv = m - 1 - t1_root if t1_root is not None else None
                par = {m - 1 - k: (m - 1 - v if v is not None else None)
                       for k, v in t1_parent.items()}
                ch = {m - 1 - k: [m - 1 - c for c in v]
                      for k, v in t1_children.items()}
            self.trees.append((rootv, par, ch))
        half = self.count // 2
        self.halves = [(0, half), (half, self.count)]

    def v_of(self, rank: int) -> int:
        return (rank - self.root - 1) % self.gsize

    def rank_of(self, v: int) -> int:
        return (v + self.root + 1) % self.gsize


class BcastDbt(_DbtBase):
    def run(self):
        self._setup()
        args = self.args
        buf = binfo_typed(args.src, self.count)
        if self.gsize == 1:
            return
        me = self.grank
        if me == self.root:
            reqs = []
            for t, (rootv, _, _) in enumerate(self.trees):
                lo, hi = self.halves[t]
                if hi > lo and rootv is not None:
                    reqs.append(self.send_nb(self.rank_of(rootv),
                                             buf[lo:hi], slot=140 + t))
            yield from self.wait(*reqs)
            return
        v = self.v_of(me)
        recvs = {}
        for t, (rootv, parent, _) in enumerate(self.trees):
            lo, hi = self.halves[t]
            if hi <= lo:
                continue
            src_rank = self.root if v == rootv else \
                self.rank_of(parent[v]) if parent.get(v) is not None else \
                self.root
            recvs[t] = self.recv_nb(src_rank, buf[self.halves[t][0]:
                                                  self.halves[t][1]],
                                    slot=140 + t)
        forwarded = set()
        while len(forwarded) < len(recvs):
            progressed = False
            for t, rreq in recvs.items():
                if t in forwarded or not rreq.test():
                    continue
                lo, hi = self.halves[t]
                sends = [self.send_nb(self.rank_of(c), buf[lo:hi],
                                      slot=140 + t)
                         for c in self.trees[t][2].get(v, [])]
                yield from self.wait(*sends)
                forwarded.add(t)
                progressed = True
            if len(forwarded) < len(recvs) and not progressed:
                yield


class ReduceDbt(_DbtBase):
    """Reverse flow: leaves up to each tree root, tree roots to coll root.
    Non-root ranks contribute src; root lands the halves in dst."""

    def run(self):
        self._setup()
        args = self.args
        op = args.op if args.op is not None else ReductionOp.SUM
        red_op = ReductionOp.SUM if op == ReductionOp.AVG else op
        nd = storage_dtype(self.dt)
        me = self.grank
        p = self.gsize
        if p == 1:
            dst = binfo_typed(args.dst, self.count)
            if not args.is_inplace:
                dst[:] = binfo_typed(args.src, self.count)
            if op == ReductionOp.AVG:
                dst[:] = reduce_arrays([dst], ReductionOp.SUM, self.dt,
                                       alpha=1.0)
            return
        if me == self.root:
            dst = binfo_typed(args.dst, self.count)
            if not args.is_inplace:
                dst[:] = binfo_typed(args.src, self.count)
            recvs = []
            scratch = self.scratch("root", self.count, nd)
            for t, (rootv, _, _) in enumerate(self.trees):
                lo, hi = self.halves[t]
                if hi > lo and rootv is not None:
                    recvs.append((t, self.recv_nb(self.rank_of(rootv),
                                                  scratch[lo:hi],
                                                  slot=150 + t)))
            yield from self.wait(*[r for _, r in recvs])
            for t, _ in recvs:
                lo, hi = self.halves[t]
                acc = dst[lo:hi]
                reduce_arrays([acc, scratch[lo:hi]], red_op, self.dt,
                              out=acc)
            if op == ReductionOp.AVG:
                dst[:] = reduce_arrays([dst], ReductionOp.SUM, self.dt,
                                       alpha=1.0 / p)
            return
        v = self.v_of(me)
        src = binfo_typed(args.src, self.count)
        acc = self.scratch("acc", self.count, nd)
        acc[:] = src
        # post BOTH trees' child receives up front so the two half-message
        # pipelines overlap (the point of DBT), then drain each as it lands
        pending = {}
        for t, (rootv, parent, children) in enumerate(self.trees):
            lo, hi = self.halves[t]
            if hi <= lo:
                continue
            kids = children.get(v, [])
            kid_buf = self.scratch(("kids", t), (len(kids), hi - lo), nd) \
                if kids else None
            reqs = [self.recv_nb(self.rank_of(c), kid_buf[i], slot=150 + t)
                    for i, c in enumerate(kids)]
            pending[t] = (reqs, kid_buf, kids)
        done = set()
        while len(done) < len(pending):
            progressed = False
            for t, (reqs, kid_buf, kids) in pending.items():
                if t in done or not all(r.test() for r in reqs):
                    continue
                rootv, parent, _ = self.trees[t]
                lo, hi = self.halves[t]
                if kids:
                    seg = acc[lo:hi]
                    reduce_arrays(
                        [seg] + [kid_buf[i] for i in range(len(kids))],
                        red_op, self.dt, out=seg)
                up = self.root if v == rootv else self.rank_of(parent[v])
                yield from self.wait(self.send_nb(up, acc[lo:hi],
                                                  slot=150 + t))
                done.add(t)
                progressed = True
            if len(done) < len(pending) and not progressed:
                yield


class AllreduceDbt(_DbtBase):
    """Fused allreduce over the double binary tree: each half reduces UP
    its tree to the virtual root (rank `root`) and broadcasts back DOWN
    the same tree, the two trees running concurrently and each tree's
    down-phase starting the moment ITS half lands at the root — no
    barrier between reduce and bcast (the reference's fused
    allreduce-DBT; reduce_dbt.c + bcast_dbt.c flows over one task)."""

    def run(self):
        args = self.args
        self.args.root = 0          # virtual root for the fused flow
        self._setup()
        op = args.op if args.op is not None else ReductionOp.SUM
        red_op = ReductionOp.SUM if op == ReductionOp.AVG else op
        nd = storage_dtype(self.dt)
        work = binfo_typed(args.dst, self.count)
        if not args.is_inplace:
            work[:] = binfo_typed(args.src, self.count)
        if self.gsize == 1:
            if op == ReductionOp.AVG:
                work[:] = reduce_arrays([work], ReductionOp.SUM, self.dt,
                                        alpha=1.0)
            return
        me = self.grank
        n = self.gsize

        def tree_flow(t):
            """Reduce up + bcast down for half t through tree t."""
            rootv, parent, children = self.trees[t]
            lo, hi = self.halves[t]
            if hi <= lo:
                return
            half = work[lo:hi]
            slot_up = 150 + t
            slot_dn = 152 + t
            if me == 0:                       # virtual root
                if rootv is not None:
                    tr = self.rank_of(rootv)
                    buf = self.scratch(("up", t), hi - lo, nd)
                    rreq = self.recv_nb(tr, buf, slot=slot_up)
                    yield from self.wait(rreq)
                    reduce_arrays([half, buf], red_op, self.dt, out=half)
                if op == ReductionOp.AVG:
                    half[:] = reduce_arrays([half], ReductionOp.SUM,
                                            self.dt, alpha=1.0 / n)
                if rootv is not None:
                    sreq = self.send_nb(self.rank_of(rootv), half,
                                        slot=slot_dn)
                    yield from self.wait(sreq)
                return
            v = self.v_of(me)
            # up: accumulate children's halves, forward to the parent or the root
            kids = children.get(v, [])
            kid_rows = self.scratch(("kids", t), (len(kids), hi - lo), nd) \
                if kids else None
            bufs = [kid_rows[i] for i in range(len(kids))]
            rreqs = [self.recv_nb(self.rank_of(c), b, slot=slot_up)
                     for c, b in zip(kids, bufs)]
            yield from self.wait(*rreqs)
            if bufs:
                reduce_arrays([half] + bufs, red_op, self.dt, out=half)
            up_to = 0 if v == rootv else self.rank_of(parent[v])
            sreq = self.send_nb(up_to, half, slot=slot_up)
            yield from self.wait(sreq)
            # down: receive the reduced half, forward to children
            dn_from = 0 if v == rootv else self.rank_of(parent[v])
            rreq = self.recv_nb(dn_from, half, slot=slot_dn)
            yield from self.wait(rreq)
            sreqs = [self.send_nb(self.rank_of(c), half, slot=slot_dn)
                     for c in kids]
            yield from self.wait(*sreqs)

        gens = [tree_flow(0), tree_flow(1)]
        done = [False, False]
        while not all(done):
            for i, g in enumerate(gens):
                if not done[i]:
                    try:
                        next(g)
                    except StopIteration:
                        done[i] = True
            if not all(done):
                yield
