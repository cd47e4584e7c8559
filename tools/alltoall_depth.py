"""How deep the alltoall kernel's tiles should be, on the GPU.

``csrc/alltoall.cu`` has a lane take up to ``A2A_UNROLL`` vector slots of a
tile and issue all their loads before any store; the registers that takes
set how many CTAs an SM holds, and the grid is sized from that occupancy.
This tool compiles copies of the source with another ``A2A_UNROLL`` (and,
optionally, a minimum of CTAs per SM in ``__launch_bounds__``, which
trades registers for occupancy) by a text substitution, checks each copy
bitwise against torch.cat of block r, and times it in turns with n x
``torch.cat`` of block r (the yardstick of chip_smoke.py's alltoall rows)
at the main path's shapes: 8 ranks of 16 Mi and of 64 Ki f32. It prints
each copy's registers and spills (``nvcc -Xptxas -v``), its occupancy cap,
one line of times per copy and shape, and the card's name and power limit.

Run on a machine with a CUDA GPU and nvcc:

    python tools/alltoall_depth.py [--reps 20]

Nothing of the package calls it.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

UNROLL = "constexpr int A2A_UNROLL = 8;"
BOUNDS = "__launch_bounds__(THREADS) alltoall_kernel"
#: copies: (A2A_UNROLL, least CTAs per SM or 0 for none)
COPIES = [(8, 0), (4, 0), (2, 0), (4, 4), (8, 2)]
SHAPES = (16 << 20, 64 << 10)
N = 8


def compile_copy(out_dir, source, name, replacements):
    """Compile a copy of csrc/*source* with each (old, new) text of
    *replacements* substituted, as lib<name>.so in *out_dir* (which holds
    copies of the headers); returns (library path, -Xptxas -v report)."""
    from ucc_tpu_torch.kernels import build as kb
    with open(os.path.join(kb.CSRC, source)) as fh:
        text = fh.read()
    for old, new in replacements:
        if old not in text:
            raise RuntimeError(f"csrc/{source} no longer has the text this "
                               f"tool substitutes: {old!r}")
        text = text.replace(old, new)
    src = os.path.join(out_dir, name + ".cu")
    with open(src, "w") as fh:
        fh.write(text)
    lib = os.path.join(out_dir, f"lib{name}.so")
    proc = subprocess.run([kb.nvcc_path(), *kb.NVCC_FLAGS, "-Xptxas", "-v",
                           "-o", lib, src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return lib, proc.stdout + proc.stderr


def ptxas_summary(report):
    """(registers, spill stores in bytes) of a -Xptxas -v report, each a
    sorted list over the copy's kernel instances."""
    regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers",
                                               report)})
    spills = sorted({int(b) for b in re.findall(r"(\d+) bytes spill stores",
                                                report)})
    return regs, spills


def load_copy(path, source, prefix):
    """A DirectSource for csrc/*source* whose library is the copy at
    *path*, with C entry points named by *prefix*."""
    from ucc_tpu_torch.kernels import ring_common as kc
    src = kc.DirectSource(source, prefix)
    lib = ctypes.CDLL(path)
    launch = getattr(lib, prefix)
    launch.argtypes, launch.restype = src.ARGTYPES, ctypes.c_int
    query = getattr(lib, prefix + "_max_ctas")
    query.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    query.restype = ctypes.c_int
    names = getattr(lib, prefix + "_error_string")
    names.argtypes, names.restype = [ctypes.c_int], ctypes.c_char_p
    src._lib = lib
    return src


def copy_headers(prefix):
    """A fresh directory holding copies of csrc's headers."""
    from ucc_tpu_torch.kernels import build as kb
    out_dir = tempfile.mkdtemp(prefix=prefix)
    for header in ("direct_fold.cuh", "ring_common.cuh"):
        shutil.copy(os.path.join(kb.CSRC, header), out_dir)
    return out_dir


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    import torch
    import chip_smoke as cs
    from ucc_tpu_torch.kernels import ring_bcast_a2a as kba
    from ucc_tpu_torch.kernels import ring_common as kc
    if not torch.cuda.is_available():
        print("alltoall_depth: no CUDA device", file=sys.stderr)
        return 2
    smi = cs.smi_line()
    out_dir = copy_headers("alltoall_depth_")
    copies = {}
    for unroll, min_ctas in COPIES:
        subs = [(UNROLL, f"constexpr int A2A_UNROLL = {unroll};")]
        if min_ctas:
            subs.append((BOUNDS, f"__launch_bounds__(THREADS, {min_ctas}) "
                                 "alltoall_kernel"))
        lib, report = compile_copy(out_dir, "alltoall.cu",
                                   f"alltoall_{unroll}_{min_ctas}", subs)
        regs, spills = ptxas_summary(report)
        copies[(unroll, min_ctas)] = load_copy(lib, "alltoall.cu",
                                               "ucc_alltoall")
        print(f"copy unroll={unroll} min_ctas={min_ctas}: registers {regs}, "
              f"spill stores {spills} bytes", flush=True)
    shipped = kba._A2A_SOURCE
    try:
        for count in SHAPES:
            g = torch.Generator(device="cuda").manual_seed(count)
            srcs = [torch.randn(count, generator=g, device="cuda")
                    for _ in range(N)]
            want = cs.alltoall_expected(srcs)
            dsts = [torch.empty_like(s) for s in srcs]
            table = kc.make_ptr_table(srcs, dsts)
            b = count // N

            def library():
                for r, o in enumerate(dsts):
                    torch.cat([s[r * b:(r + 1) * b] for s in srcs], out=o)

            def kernel():
                kba.ring_alltoall_chunked(srcs, dsts, ptr_table=table)

            for (unroll, min_ctas), src in copies.items():
                kba._A2A_SOURCE = src
                cap = src.max_ctas(0, kc.DTYPE_CODES[torch.float32],
                                   torch.device("cuda", 0),
                                   kc.DIRECT_THREADS)
                for d in dsts:
                    d.fill_(7)
                kernel()
                torch.cuda.synchronize()
                cs.compare(f"copy {unroll}/{min_ctas}", dsts, want)
                turns = [cs.cuda_ms(f, args.reps) for f in
                         (library, kernel, kernel, library)]
                print(f"{N} x {count} f32, unroll={unroll} "
                      f"min_ctas={min_ctas} ({cap} CTAs): in turns "
                      f"(n x torch.cat, kernel, kernel, n x torch.cat) "
                      f"{', '.join(f'{t:.4f}' for t in turns)} ms",
                      flush=True)
            del srcs, dsts, want
            torch.cuda.empty_cache()
    finally:
        kba._A2A_SOURCE = shipped
        shutil.rmtree(out_dir, ignore_errors=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
