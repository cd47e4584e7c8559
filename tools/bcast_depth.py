"""How many vectors the bcast kernel's threads should load before they
store, on the GPU.

``csrc/bcast.cu`` has a thread load ``BCAST_UNROLL`` 16-byte vectors of
the root's src before it stores each of them into every dst; the registers
that takes set how many CTAs an SM holds, and the grid is sized from that
occupancy. This tool compiles copies of the source with another
``BCAST_UNROLL`` by a text substitution (``alltoall_depth.compile_copy``),
checks each copy bitwise against the root's data, and times it in turns
with (n-1) x ``copy_`` (the yardstick of chip_smoke.py's bcast rows) at the
main path's shapes: 8 ranks of 16 Mi f32 from root 3 and of 64 Ki f32 from
root 0, in place, as UCC's bcast passes src alone. It prints each copy's
build time (one nvcc with ``-Xptxas -v``, nothing else building), its
registers and spills, its occupancy cap, one line of times per copy and
shape, and the card's name and power limit.

Run on a machine with a CUDA GPU and nvcc:

    python tools/bcast_depth.py [--reps 20]

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

UNROLL = "constexpr int BCAST_UNROLL = 8;"
DEPTHS = (8, 4, 2)
#: (f32 elements per rank, root) of the main path's two bcasts
SHAPES = ((16 << 20, 3), (64 << 10, 0))
N = 8


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    import torch
    import chip_smoke as cs
    from ucc_tpu_torch.kernels import ring_bcast_a2a as kba
    from ucc_tpu_torch.kernels import ring_common as kc
    if not torch.cuda.is_available():
        print("bcast_depth: no CUDA device", file=sys.stderr)
        return 2
    smi = cs.smi_line()
    out_dir = copy_headers("bcast_depth_")
    copies = {}
    for unroll in DEPTHS:
        t0 = time.perf_counter()
        lib, report = compile_copy(
            out_dir, "bcast.cu", f"bcast_{unroll}",
            [(UNROLL, f"constexpr int BCAST_UNROLL = {unroll};")])
        built = time.perf_counter() - t0
        regs, spills = ptxas_summary(report)
        copies[unroll] = load_copy(lib, "bcast.cu", "ucc_bcast")
        print(f"copy unroll={unroll}: built alone in {built:.1f} s, "
              f"registers {regs}, spill stores {spills} bytes", flush=True)
    shipped = kba._SOURCE
    try:
        for count, root in SHAPES:
            g = torch.Generator(device="cuda").manual_seed(count)
            data = torch.randn(count, generator=g, device="cuda")
            bufs = [torch.randn(count, generator=g, device="cuda")
                    for _ in range(N)]
            bufs[root].copy_(data)
            table = kc.make_ptr_table(bufs, bufs)

            def library():
                for r, b in enumerate(bufs):
                    if r != root:
                        b.copy_(data)

            def kernel():
                kba.ring_bcast_chunked(bufs, bufs, root=root,
                                       ptr_table=table)

            for unroll, src in copies.items():
                kba._SOURCE = src
                cap = src.max_ctas(0, kc.DTYPE_CODES[torch.float32],
                                   torch.device("cuda", 0),
                                   kc.DIRECT_THREADS)
                for r, b in enumerate(bufs):
                    if r != root:
                        b.fill_(7)
                kernel()
                torch.cuda.synchronize()
                cs.compare(f"copy {unroll}", bufs, [data] * N)
                turns = [cs.cuda_ms(f, args.reps) for f in
                         (library, kernel, kernel, library)]
                print(f"{N} x {count} f32 from root {root}, unroll={unroll} "
                      f"({cap} CTAs): in turns ((n-1) x copy_, kernel, "
                      f"kernel, (n-1) x copy_) "
                      f"{', '.join(f'{t:.4f}' for t in turns)} ms",
                      flush=True)
            del data, bufs
            torch.cuda.empty_cache()
    finally:
        kba._SOURCE = shipped
        shutil.rmtree(out_dir, ignore_errors=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
