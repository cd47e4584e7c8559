"""How many vector slots the allgather kernel's lanes should load before
they store, on the GPU.

``csrc/allgather.cu`` has a lane take up to ``AG_UNROLL`` 16-byte vector
slots of a tile of src_b and issue all their loads before it stores each
of them into every dst; the registers that takes set how many CTAs an SM
holds, and the grid is sized from that occupancy. This tool compiles
copies of the source with another ``AG_UNROLL`` by a text substitution
(``alltoall_depth.compile_copy``), checks each copy byte for byte against
``torch.cat(srcs)``, and times it in turns with n x ``torch.cat(srcs,
out=dst)`` (the yardstick of chip_smoke.py's allgather rows) at the main
path's shapes: 8 ranks of 2 Mi f32 in (16 Mi out) and of 8 Ki f32 in. It
prints each copy's build time (one nvcc with ``-Xptxas -v``, nothing else
building), its registers and spills, its occupancy cap, one line of
times per copy and shape, and the card's name and power limit.

Run on a machine with a CUDA GPU and nvcc:

    python tools/allgather_depth.py [--reps 20]

Nothing of the package calls it.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from alltoall_depth import (compile_copy, copy_headers,  # noqa: E402
                            load_copy, ptxas_summary)

UNROLL = "constexpr int AG_UNROLL = 8;"
DEPTHS = (8, 4, 2)
#: f32 elements per rank in, of the main path's two allgathers
SHAPES = (2 << 20, 8 << 10)
N = 8


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    import torch
    import chip_smoke as cs
    from ucc_tpu_torch.kernels import ring_common as kc
    from ucc_tpu_torch.kernels import ring_rs_ag as krs
    if not torch.cuda.is_available():
        print("allgather_depth: no CUDA device", file=sys.stderr)
        return 2
    smi = cs.smi_line()
    out_dir = copy_headers("allgather_depth_")
    copies = {}
    for unroll in DEPTHS:
        t0 = time.perf_counter()
        lib, report = compile_copy(
            out_dir, "allgather.cu", f"allgather_{unroll}",
            [(UNROLL, f"constexpr int AG_UNROLL = {unroll};")])
        built = time.perf_counter() - t0
        regs, spills = ptxas_summary(report)
        copies[unroll] = load_copy(lib, "allgather.cu", "ucc_allgather")
        print(f"copy unroll={unroll}: built alone in {built:.1f} s, "
              f"registers {regs}, spill stores {spills} bytes", flush=True)
    shipped = krs._SOURCE
    try:
        for count in SHAPES:
            g = torch.Generator(device="cuda").manual_seed(count)
            srcs = [torch.randn(count, generator=g, device="cuda")
                    for _ in range(N)]
            cat = torch.cat(srcs)
            dsts = [torch.empty(N * count, device="cuda") for _ in range(N)]
            table = kc.make_ptr_table(srcs, dsts)

            def library():
                for d in dsts:
                    torch.cat(srcs, out=d)

            def kernel():
                krs.ring_allgather_chunked(srcs, dsts, ptr_table=table)

            for unroll, src in copies.items():
                krs._SOURCE = src
                cap = src.max_ctas(0, kc.DTYPE_CODES[torch.float32],
                                   torch.device("cuda", 0),
                                   kc.DIRECT_THREADS)
                for d in dsts:
                    d.fill_(7)
                kernel()
                torch.cuda.synchronize()
                for r, d in enumerate(dsts):
                    if not cs.raw_equal(d, cat):
                        raise AssertionError(f"copy {unroll}: rank {r} is "
                                             f"not torch.cat(srcs)")
                turns = [cs.cuda_ms(f, args.reps) for f in
                         (library, kernel, kernel, library)]
                print(f"{N} x {count} f32 in, unroll={unroll} ({cap} "
                      f"CTAs): in turns (n x torch.cat, kernel, kernel, "
                      f"n x torch.cat) "
                      f"{', '.join(f'{t:.4f}' for t in turns)} ms",
                      flush=True)
            del srcs, dsts, cat
            torch.cuda.empty_cache()
    finally:
        krs._SOURCE = shipped
        shutil.rmtree(out_dir, ignore_errors=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
