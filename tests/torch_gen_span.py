"""Helpers of the tests of the generated device collectives by part (not a
test file; it imports no JAX).

- ``route``: the kernel route of a plan, as ``kernels/gen_device`` picks it.
- ``union`` / ``check_parts``: the P parts of one wrapper call on CPU
  tensors (the plain versions), one after the other on the same buffers,
  as the P processes of a spanning team launch them.
"""
from __future__ import annotations

import torch

from ucc_tpu_torch.kernels import gen_device as kgd

#: a value no result holds: what an element outside every part keeps
FILL = 12345.0


def route(plan) -> str:
    fp = kgd.fold_plan(plan)
    return "layer" if fp is None else ("wire fold" if fp.qmode else "fold")


def wrapper(plan):
    return kgd.gen_device_ring if plan.ring else kgd.gen_device_gen


def _bits(t):
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _call(plan, ins, outs, op, part=None):
    kw = {} if part is None else {"part": part}
    wrapper(plan)(ins, outs, op, plan=plan, **kw).wait()


def _buffers(srcs, inplace):
    ins = [s.clone() for s in srcs]
    return ins, (ins if inplace else
                 [torch.full_like(s, FILL) for s in srcs])


def union(plan, srcs, op, nparts, inplace=False):
    """The dsts after parts 0..P-1, each writing the same buffers."""
    ins, outs = _buffers(srcs, inplace)
    for p in range(nparts):
        _call(plan, ins, outs, op, (p, nparts))
    return outs


def check_parts(plan, srcs, op, parts, inplace=False) -> int:
    """For each P in *parts*: every part alone writes exactly its
    ``part_walk`` elements of every rank's dst, bitwise the single call
    there, and keeps every other element (FILL, or the src in place);
    the union of the P parts is bitwise the single call. Returns the
    parts checked."""
    ins, whole = _buffers(srcs, inplace)
    _call(plan, ins, whole, op)
    checked = 0
    for nparts in parts:
        for p in range(nparts):
            ins, outs = _buffers(srcs, inplace)
            before = [o.clone() for o in outs]
            _call(plan, ins, outs, op, (p, nparts))
            _, _, elo, ehi = kgd.part_walk(plan, (p, nparts),
                                           srcs[0].element_size())
            for r, (o, b, w) in enumerate(zip(outs, before, whole)):
                assert torch.equal(_bits(o[elo:ehi]), _bits(w[elo:ehi])), \
                    (plan.n, nparts, p, r, "inside")
                assert torch.equal(_bits(o[:elo]), _bits(b[:elo])) and \
                    torch.equal(_bits(o[ehi:]), _bits(b[ehi:])), \
                    (plan.n, nparts, p, r, "outside")
            checked += 1
        got = union(plan, srcs, op, nparts, inplace)
        for r, (g, w) in enumerate(zip(got, whole)):
            assert torch.equal(_bits(g), _bits(w)), (plan.n, nparts, r,
                                                     "union")
    return checked
