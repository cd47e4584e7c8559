"""Where the wire fold's time goes, on the GPU, without a profiler.

``csrc/gen_device.cu``'s wire fold (``gen_wire_fold_kernel``) runs a wire
plan as one pass, one warp per qblock group: loads of up to
``WIRE_LEAVES`` leaves, then the program's steps, whose QDQs (a butterfly
absmax, then per value an IEEE division by the group's scale, a rounding
and, for fp8, conversions) are most of its arithmetic. This tool compiles copies of the source by a text
substitution (one nvcc with ``-Xptxas -v`` per copy, all started
together) and times each in turns with the shipped copy at the main
path's wire shape: the int8 and fp8 edge-wired direct exchanges of 8 ranks
x 16 Mi f32, qblock 256. Copies:

- ``leaves_4``: 4 leaf loads in flight a warp instead of
  ``WIRE_LEAVES`` = 2;
- ``blocks_4`` and ``blocks_6``: registers capped for 4 or 6 CTAs an SM
  instead of ``WIRE_MIN_BLOCKS`` = 5;
- ``threads_256_blocks_2``: CTAs of 256 threads instead of
  ``WIRE_THREADS`` = 128, registers capped for 2 of them an SM;
- ``frnd``: int8 rounded by ``rintf`` and converted through an integer
  instead of adding and subtracting 1.5 x 2^23;
- ``no_shfl``: the absmax butterfly cut (each lane's own maximum);
- ``no_qdq``: every QDQ step skipped (what remains: the loads, the adds
  and the stores).

All but the ``no_`` copies are checked bitwise against the plain
version; the cut ones compute wrong results and only their time is read. It prints each
copy's registers and spills of the 8-values-a-lane instances, one line of
times per copy and wire type, and the card's name and power limit.

Run on a machine with a CUDA GPU and nvcc:

    python tools/wire_fold_cuts.py [--reps 10]

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

N = 8
COUNT = 16 << 20
QBLOCK = 256
#: the shipped texts that copies substitute
LEAVES = "constexpr int WIRE_LEAVES = {};"
BLOCKS = "constexpr int WIRE_MIN_BLOCKS = {};"
MAGIC = ("const float r = __fadd_rn(__fadd_rn(s, 12582912.f), -12582912.f);"
         "\n    const float qf = fminf(fmaxf(r, -127.f), 127.f);")
FRND = ("const float qf = (float)(signed char)(int)fminf(fmaxf(rintf(s), "
        "-127.f), 127.f);")
THREADS = "constexpr int WIRE_THREADS = {};"
#: copy -> [(shipped text, copy's text)]
COPIES = {
    "leaves_4": [(LEAVES.format(2), LEAVES.format(4))],
    "blocks_4": [(BLOCKS.format(5), BLOCKS.format(4))],
    "blocks_6": [(BLOCKS.format(5), BLOCKS.format(6))],
    "threads_256_blocks_2": [(THREADS.format(128), THREADS.format(256)),
                             (BLOCKS.format(5), BLOCKS.format(2))],
    "frnd": [(MAGIC, FRND)],
    "no_shfl": [("for (int o = WARP / 2; o > 0; o >>= 1)",
                 "for (int o = 0; o > 0; o >>= 1)")],
    "no_qdq": [("    qdq<QMODE, V, VEC>(top, lane, len);\n    return;",
                "    return;")],
}
#: copies whose results stay right
EXACT = tuple(k for k in COPIES if not k.startswith("no_"))


def copy_threads(name):
    """Threads of a copy's CTA."""
    return 256 if name.startswith("threads_256") else 128


def build_copies(out_dir):
    """Every copy compiled in parallel: {name: (library, report)}."""
    from ucc_tpu_torch.kernels import build, gen_device as kgd
    with open(os.path.join(build.CSRC, kgd.SOURCE)) as fh:
        text = fh.read()
    for header in ("direct_fold.cuh", "ring_common.cuh"):
        shutil.copy(os.path.join(build.CSRC, header), out_dir)
    procs = {}
    for name, pairs in COPIES.items():
        copy = text
        for old, new in pairs:
            if old not in copy:
                raise RuntimeError(f"csrc/{kgd.SOURCE} no longer has the "
                                   f"text this tool substitutes: {old!r}")
            copy = copy.replace(old, new)
        src = os.path.join(out_dir, f"{name}.cu")
        with open(src, "w") as fh:
            fh.write(copy)
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             lib, src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{report}")
        out[name] = (lib, report)
    return out


def load_copy(path):
    """A gen_device.cu source object whose library is the copy at *path*."""
    from ucc_tpu_torch.kernels import gen_device as kgd
    src = kgd._GenSource(kgd.SOURCE, "ucc_gen_device")
    lib = ctypes.CDLL(path)
    for fn, args in (("ucc_gen_device", src.ARGTYPES),
                     ("ucc_gen_wire_fold", src.WIRE_ARGTYPES)):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int
    lib.ucc_gen_device_max_ctas.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.ucc_gen_device_max_ctas.restype = ctypes.c_int
    lib.ucc_gen_device_error_string.argtypes = [ctypes.c_int]
    lib.ucc_gen_device_error_string.restype = ctypes.c_char_p
    src._lib = lib
    return src


def wide_instances(report):
    """{wire type: (registers, spill store bytes)} of the instances with 8
    values a lane in a -Xptxas -v report."""
    out, name = {}, None
    for line in report.splitlines():
        hit = re.search(r"Compiling entry function '([^']+)'", line)
        if hit:
            fn = hit.group(1)
            name = None
            if "gen_wire_fold_kernel" in fn and "ELi8EE" in fn:
                name = "int8" if "ILi1ELi8EE" in fn else "fp8"
                out[name] = [0, 0]
            continue
        if name:
            regs = re.search(r"Used (\d+) registers", line)
            if regs:
                out[name][0] = int(regs.group(1))
            spill = re.search(r"(\d+) bytes spill stores", line)
            if spill:
                out[name][1] = int(spill.group(1))
    return {k: tuple(v) for k, v in out.items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args(argv)
    import torch
    import chip_smoke as cs
    from ucc_tpu_torch import ReductionOp
    from ucc_tpu_torch.kernels import gen_device as kgd
    from ucc_tpu_torch.kernels import ring_common as kc
    if not torch.cuda.is_available():
        print("wire_fold_cuts: no CUDA device", file=sys.stderr)
        return 2
    smi = cs.smi_line()
    out_dir = tempfile.mkdtemp(prefix="wire_fold_cuts_")
    shipped = kgd._SOURCE
    sum_ = ReductionOp.SUM
    try:
        copies = {}
        for name, (lib, report) in build_copies(out_dir).items():
            copies[name] = load_copy(lib)
            print(f"copy {name}: 8-values-a-lane instances (registers, spill "
                  f"store bytes) {wide_instances(report)}", flush=True)
        for qmode in ("int8", "fp8"):
            srcs = cs.make_inputs(N, COUNT, torch.float32, sum_,
                                  50 + len(qmode))
            plan, wrapper, route = cs.gen_route(
                cs.wire_direct(N, qmode, qmode), N, COUNT, 0, QBLOCK, qmode)
            assert route == "wire fold", route
            want = kgd.gen_device_ref(srcs, plan, sum_)
            out = [torch.empty_like(s) for s in srcs]
            table = kc.make_ptr_table(srcs, out)

            def kernel():
                return wrapper(srcs, out, sum_, plan=plan, ptr_table=table)

            for name, src in copies.items():
                threads = copy_threads(name)
                kgd._SOURCE, kgd.WIRE_THREADS = src, threads
                if name in EXACT:
                    for o in out:
                        o.fill_(7)
                    kernel().wait()
                    cs.compare(f"copy {name} {qmode}", out, want)
                cap = src.max_ctas(kgd.wire_kernel(qmode, QBLOCK),
                                   kc.DTYPE_CODES[torch.float32],
                                   torch.device("cuda", 0), threads)
                turns = []
                for which in (shipped, src, src, shipped):
                    kgd._SOURCE = which
                    kgd.WIRE_THREADS = threads if which is src else 128
                    turns.append(cs.cuda_ms(kernel, args.reps))
                print(f"{N} x {COUNT} f32 {qmode} qblock {QBLOCK}, {name} "
                      f"({cap} CTAs): in turns (shipped, copy, copy, "
                      f"shipped) {', '.join(f'{t:.4f}' for t in turns)} ms",
                      flush=True)
            kgd._SOURCE, kgd.WIRE_THREADS = shipped, 128
            del srcs, want, out, table
            torch.cuda.empty_cache()
    finally:
        kgd._SOURCE, kgd.WIRE_THREADS = shipped, 128
        shutil.rmtree(out_dir, ignore_errors=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
