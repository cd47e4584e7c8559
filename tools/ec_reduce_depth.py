"""How many vectors of each source the EC reduce's threads should load
before they fold, on the GPU.

``csrc/ec_reduce.cu``'s vector kernel has a thread take ``kDepth`` 16-byte
vectors and issue the loads of ``kGroup`` sources for all of them before
it folds them; the registers that takes set how many blocks an SM holds,
and the grid is sized from that occupancy. This tool compiles copies of
the source with other ``kDepth`` and ``kGroup``, and with registers
capped for a least number of blocks an SM (``__launch_bounds__``), by a
text substitution (one nvcc with ``-Xptxas -v`` per copy, all started
together), checks each copy bitwise against the plain version
``ec_reduce_ref``, and times it in turns with ``torch.stack(srcs).sum(0)``
(the yardstick of chip_smoke.py's ec_reduce row) at the three shapes of
the main path's ``perftest reducedt`` runs: 2 f32 sources of 64 MiB, 9
bf16 sources of 32 MiB and 2 f32 sources of 256 KiB. It prints each
copy's registers and spills (the vector kernel's f32 and bf16 SUM
instances), one line of times per copy and shape, and the card's name and
power limit.

Run on a machine with a CUDA GPU and nvcc:

    python tools/ec_reduce_depth.py [--reps 20]

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

DEPTH = "constexpr int kDepth = {};"
GROUP = "constexpr int kGroup = {};"
BOUNDS = "__launch_bounds__(kThreads{}) ec_reduce_vec_kernel"
#: copies: (kDepth, kGroup, least blocks an SM as ", N" or ""); the first
#: is the shipped one
COPIES = [(1, 3, ""), (1, 2, ""), (1, 4, ""), (1, 5, ""), (2, 3, ""),
          (2, 2, ""), (1, 9, ""), (1, 3, ", 6")]
SHIPPED = COPIES[0]
#: (torch dtype name, sources, elements per source) of the reducedt runs
SHAPES = (("float32", 2, 16 << 20), ("bfloat16", 9, 16 << 20),
          ("float32", 2, 64 << 10))


def name_of(copy):
    depth, group, bounds = copy
    return f"kDepth={depth} kGroup={group}" + (
        f" min_blocks={bounds[2:]}" if bounds else "")


def substitutions(copy):
    return [(DEPTH.format(SHIPPED[0]), DEPTH.format(copy[0])),
            (GROUP.format(SHIPPED[1]), GROUP.format(copy[1])),
            (BOUNDS.format(SHIPPED[2]), BOUNDS.format(copy[2]))]


def build_copies(out_dir):
    """Every copy compiled in parallel: {name: (library, report)}."""
    from ucc_tpu_torch.kernels import build, ec_reduce as ker
    with open(os.path.join(build.CSRC, ker.SOURCE)) as fh:
        text = fh.read()
    procs = {}
    for i, copy in enumerate(COPIES):
        out = text
        for old, new in substitutions(copy):
            if old not in out:
                raise RuntimeError(f"csrc/{ker.SOURCE} no longer has the "
                                   f"text this tool substitutes: {old!r}")
            out = out.replace(old, new)
        src = os.path.join(out_dir, f"ec_reduce_{i}.cu")
        with open(src, "w") as fh:
            fh.write(out)
        lib = os.path.join(out_dir, f"libec_reduce_{i}.so")
        procs[name_of(copy)] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             lib, src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{report}")
        built[name] = (lib, report)
    return built


def load_copy(path):
    """The copy's library with the shipped one's C signatures."""
    lib = ctypes.CDLL(path)
    lib.ucc_ec_reduce.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double,
        ctypes.c_int, ctypes.c_void_p]
    lib.ucc_ec_reduce.restype = ctypes.c_int
    lib.ucc_ec_reduce_error_string.argtypes = [ctypes.c_int]
    lib.ucc_ec_reduce_error_string.restype = ctypes.c_char_p
    return lib


#: the vector kernel's f32 and bf16 SUM instances, as mangled
SUM_INSTANCES = (("f32", "ec_reduce_vec_kernelIfLi0EE"),
                 ("bf16", "ec_reduce_vec_kernelI13__nv_bfloat16Li0EE"))


def sum_registers(report):
    """{instance: registers, instance spill: spill store bytes} of the f32
    and bf16 SUM instances in a -Xptxas -v report."""
    out, name = {}, None
    for line in report.splitlines():
        hit = re.search(r"Compiling entry function '([^']+)'", line)
        if hit:
            name = hit.group(1)
            continue
        for tag, mangled in SUM_INSTANCES:
            if name and mangled in name:
                regs = re.search(r"Used (\d+) registers", line)
                if regs:
                    out[tag] = int(regs.group(1))
                spill = re.search(r"(\d+) bytes spill stores", line)
                if spill:
                    out[tag + " spill"] = int(spill.group(1))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    import torch
    import chip_smoke as cs
    from ucc_tpu_torch import ReductionOp
    from ucc_tpu_torch.constants import dt_from_torch
    from ucc_tpu_torch.kernels import ec_reduce as ker
    if not torch.cuda.is_available():
        print("ec_reduce_depth: no CUDA device", file=sys.stderr)
        return 2
    smi = cs.smi_line()
    out_dir = tempfile.mkdtemp(prefix="ec_reduce_depth_")
    shipped = ker._library()
    try:
        copies = {}
        for name, (lib, report) in build_copies(out_dir).items():
            copies[name] = load_copy(lib)
            print(f"copy {name}: SUM instances' registers and spill store "
                  f"bytes {sum_registers(report)}", flush=True)
        for dname, k, count in SHAPES:
            td = getattr(torch, dname)
            dt = dt_from_torch(td)
            srcs = cs.ec_inputs(td, count, k, "plain", 40 + k)
            want = ker.ec_reduce_ref(srcs, count, dt, ReductionOp.SUM)
            dst = torch.empty_like(want)

            def kernel():
                ker.ec_reduce(dst, srcs, count, dt, ReductionOp.SUM)

            def library():
                return torch.stack(srcs).sum(0)

            for name, lib in copies.items():
                ker._lib = lib
                dst.fill_(7)
                kernel()
                torch.cuda.synchronize()
                if not cs.bits_equal(dst, want):
                    raise AssertionError(f"copy {name} {dname} k={k} "
                                         "differs from the plain version")
                turns = [cs.cuda_ms(f, args.reps) for f in
                         (library, kernel, kernel, library)]
                print(f"{k} x {count} {dname}, {name}: in turns "
                      f"(stack().sum(0), kernel, kernel, stack().sum(0)) "
                      f"{', '.join(f'{t:.4f}' for t in turns)} ms",
                      flush=True)
            del srcs, want, dst
            torch.cuda.empty_cache()
    finally:
        ker._lib = shipped
        shutil.rmtree(out_dir, ignore_errors=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
