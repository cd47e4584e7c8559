"""The five direct ring sources' single launches at chip_smoke.py's main-path
shapes, in two trees of the repo, in turns: how a change to the kernels
moves their time.

Each side runs in a process of its own from its tree (its own kernels,
wrappers and chip_smoke.MAIN_RUNS), in the order A B B A A B; each run
times every entry point 5 times (chip_smoke.cuda_ms, 200 launches, the
pointer table built once), and the medians of the two sides are printed
per kernel with their ranges and the ratio B / A, beside the card's name
and power limit. Run on a machine with a CUDA GPU, from the root of a
checkout, with the other tree unpacked beside it::

    git archive <parent commit> | tar -x -C _tree/parent
    python3 tools/direct_ab.py _tree/parent .

The last line is one JSON object with every run's times.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys

RUN = r'''
import json, sys, torch
sys.path.insert(0, ".")
sys.modules.setdefault("jax", None)
import chip_smoke as cs
from ucc_tpu_torch import ReductionOp
from ucc_tpu_torch.kernels import build
from ucc_tpu_torch.kernels import ring_allreduce as kr
from ucc_tpu_torch.kernels import ring_bcast_a2a as kba
from ucc_tpu_torch.kernels import ring_common as kc
from ucc_tpu_torch.kernels import ring_rs_ag as krs
build.build_all([kr.SOURCE, krs.RS_SOURCE, krs.SOURCE, kba.SOURCE,
                 kba.A2A_SOURCE])
kernels = cs.wrappers()
out = {}
for coll, kname, count, dst_count, root, seed in cs.MAIN_RUNS:
    wrapper, _ = kernels[kname]
    g = torch.Generator(device="cuda").manual_seed(seed)
    srcs = [torch.randn(count, generator=g, device="cuda")
            for _ in range(cs.N_RANKS)]
    if coll == "BCAST":
        ins = dsts = [s.clone() for s in srcs]
        op = None
    else:
        ins, op = srcs, ReductionOp.SUM
        dsts = [torch.empty(dst_count, device="cuda")
                for _ in range(cs.N_RANKS)]
    table = kc.make_ptr_table(ins, dsts)
    out[kname] = [cs.cuda_ms(lambda: wrapper(ins, dsts, op, root=root,
                                             ptr_table=table), 200)
                  for _ in range(5)]
    del srcs, ins, dsts, table
    torch.cuda.empty_cache()
print(json.dumps(out))
'''


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"A": args[0], "B": args[1]}
    runs = {"A": [], "B": []}
    for side in ("A", "B", "B", "A", "A", "B"):
        res = subprocess.run([sys.executable, "-c", RUN], cwd=trees[side],
                             capture_output=True, text=True, timeout=900)
        if res.returncode:
            print(f"{side} ({trees[side]}) failed:\n{res.stderr[-4000:]}",
                  file=sys.stderr)
            return 1
        runs[side].append(json.loads(res.stdout.strip().splitlines()[-1]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"A = {trees['A']}, B = {trees['B']} | card {smi}")
    for k in runs["A"][0]:
        a = [m for run in runs["A"] for m in run[k]]
        b = [m for run in runs["B"] for m in run[k]]
        ma, mb = statistics.median(a), statistics.median(b)
        print(f"{k}: A {ma:.5f} ms [{min(a):.5f}, {max(a):.5f}], B "
              f"{mb:.5f} ms [{min(b):.5f}, {max(b):.5f}], B / A "
              f"{mb / ma:.4f}")
    print(json.dumps({"card": smi, "trees": trees, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
