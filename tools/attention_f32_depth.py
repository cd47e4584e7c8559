"""Which tiles the f32 attention kernel should use, on the GPU.

``csrc/ring_flash_attn.cu`` runs float32 inputs on the CUDA cores with
CTAs of ``kF32BQ`` query rows folding key tiles of ``kF32BK`` keys (at head
dims up to 128). The tile sizes set each thread's register tiles, the
FFMAs per shared load, the shared memory a CTA takes and so how many CTAs
an SM holds; how far the score loop (S = Q·Kᵀ) and the P·V loop are
unrolled sets how early a warp's shared loads are issued. This tool
compiles copies of the source with other values of the two constants and
other unroll depths of the two loops by a text substitution (one nvcc
with ``-Xptxas -v`` per copy, all started together), checks each copy
against the plain version
within the f32 tolerance, and times it in turns with the shipped kernel
and with ``scaled_dot_product_attention`` in f32 (TF32 off) at the main
path's shape: 8 ranks x 1024 rows, 32 query heads over 8 K/V heads, head
dim 128, causal. Three more copies of the shipped tiles have a loop cut
out (its bound set to 0), so that where the time goes shows without a
profiler: ``no_s`` (S = Q·Kᵀ; the scores stay 0), ``no_pv`` (P·V) and
``no_mma`` (both: what remains is the copies, the softmax and the
barriers). A cut copy computes wrong results: only its time is read. It
prints each copy's registers and spills at head dim 128, one line of times
per copy, and the card's name and power limit.

Run on a machine with a CUDA GPU and nvcc:

    python tools/attention_f32_depth.py [--reps 10]

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

N, H, H_KV, S, D = 8, 32, 8, 1024, 128
#: the substituted lines, as format strings
ROWS = "constexpr int kF32BQ = {};"
KEYS = "constexpr int kF32BK = {};"
S_LOOP = "#pragma unroll {}\n    for (int c = 0; c < {}; c += 4) {{"
PV_LOOP = "#pragma unroll {}\n    for (int k = 0; k < {}; k += 4) {{"
#: the shipped copy, as the source has it: (query rows of a CTA, keys of a
#: tile, unroll of the S loop, unroll of the P·V loop, the loop cut out)
#: at head dims up to 128
SHIPPED = (128, 64, 8, 4, "")
#: copies: other tiles, other unroll depths of the shipped tiles, then the
#: shipped copy with a loop cut out
COPIES = [SHIPPED, (64, 64, 8, 4, ""), (128, 32, 8, 4, ""),
          (64, 32, 8, 4, ""), (128, 64, 4, 2, ""), (128, 64, 8, 2, ""),
          (128, 64, 4, 4, ""), (128, 64, 8, 8, ""), (128, 64, 8, 4, "no_s"),
          (128, 64, 8, 4, "no_pv"), (128, 64, 8, 4, "no_mma")]


def substitutions(copy):
    """The (shipped text, copy's text) pairs that make *copy*."""
    bq, bk, s_unroll, pv_unroll, cut = copy
    s_end = "0" if cut in ("no_s", "no_mma") else "DT"
    pv_end = "0" if cut in ("no_pv", "no_mma") else "BK"
    return [(ROWS.format(SHIPPED[0]), ROWS.format(bq)),
            (KEYS.format(SHIPPED[1]), KEYS.format(bk)),
            (S_LOOP.format(SHIPPED[2], "DT"), S_LOOP.format(s_unroll, s_end)),
            (PV_LOOP.format(SHIPPED[3], "BK"),
             PV_LOOP.format(pv_unroll, pv_end))]


def build_copies(out_dir):
    """Every copy compiled in parallel and loaded: {tiles: (library,
    -Xptxas -v report)}."""
    from ucc_tpu_torch.kernels import build, ring_attention as ka
    with open(os.path.join(build.CSRC, ka.SOURCE)) as fh:
        source = fh.read()
    procs = {}
    for copy in COPIES:
        text = source
        for old, new in substitutions(copy):
            if text.count(old) != 1:
                raise RuntimeError(f"csrc/{ka.SOURCE} no longer has "
                                   f"{old!r} once")
            text = text.replace(old, new)
        name = stem(copy)
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as fh:
            fh.write(text)
        procs[copy] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(out_dir, f"lib{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for copy, proc in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label(copy)}:\n{report}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"lib{stem(copy)}.so"))
        lib.ucc_ring_flash_attn.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        lib.ucc_ring_flash_attn.restype = ctypes.c_int
        libs[copy] = lib, report
    return libs


def label(copy):
    """'128x64 S/8 PV/4': tiles, the unroll of each loop, the cut."""
    return f"{copy[0]}x{copy[1]} S/{copy[2]} PV/{copy[3]} {copy[4]}".strip()


def stem(copy):
    return "f32_" + "_".join(str(x) for x in copy if x != "")


def f32_registers(report):
    """{instance at DT 128: (registers, spill stores, spill loads)} of a
    -Xptxas -v report (mangled names: ring_flash_attn_kernel<128, VEC>)."""
    out, name = {}, None
    for line in report.splitlines():
        hit = re.search(r"Compiling entry function '([^']+)'", line)
        if hit:
            name = hit.group(1)
        if not name or "ring_flash_attn_kernelILi128E" not in name:
            continue
        vec = "VEC" if "Lb1E" in name else "4-byte"
        hit = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        line)
        if hit:
            out.setdefault(vec, {})["spills"] = (int(hit.group(1)),
                                                 int(hit.group(2)))
        hit = re.search(r"Used (\d+) registers", line)
        if hit:
            out.setdefault(vec, {})["registers"] = int(hit.group(1))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args(argv)
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    from ucc_tpu_torch.kernels import ring_attention as ka
    if not torch.cuda.is_available():
        print("attention_f32_depth: no CUDA device", file=sys.stderr)
        return 2
    smi = cs.smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = tempfile.mkdtemp(prefix="attention_f32_depth_")
    try:
        libs = build_copies(out_dir)
        for copy, (_, report) in libs.items():
            print(f"copy {label(copy)}: DT 128 instances "
                  f"{f32_registers(report)}", flush=True)
        g = torch.Generator(device="cuda").manual_seed(14)
        qs, ks, vs = ([torch.randn(heads, S, D, generator=g, device="cuda")
                       for _ in range(N)] for heads in (H, H_KV, H_KV))
        scale = ka.default_scale(D)
        outs = [torch.empty_like(q) for q in qs]
        ptrs = (ctypes.c_void_p * (4 * N))(
            *[t.data_ptr() for t in (*qs, *ks, *vs, *outs)])
        want = ka.ring_flash_attention_ref(qs, ks, vs, scale, True)
        q, k, v = (torch.cat(t, dim=1)[None] for t in (qs, ks, vs))

        def launcher(lib):
            def launch():
                rc = lib.ucc_ring_flash_attn(
                    ka.DTYPE_CODES[torch.float32], ptrs, N, H, H_KV, S, D,
                    scale, 1, torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"launch failed: CUDA error {rc}")
            return launch

        def sdpa():
            F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                           enable_gqa=True)

        shipped = launcher(libs[SHIPPED][0])
        for copy, (lib, _) in libs.items():
            run = launcher(lib)
            for o in outs:
                o.fill_(float("nan"))
            run()
            torch.cuda.synchronize()
            err = "cut" if copy[4] else cs.compare_attention(
                outs, want, f"copy {label(copy)}")
            turns = [cs.cuda_ms(f, args.reps) for f in
                     (sdpa, shipped, run, run, shipped, sdpa)]
            print(f"{N} x {S} rows, {H} heads over {H_KV}, d {D}, f32, "
                  f"causal, copy {label(copy)} (max abs err {err}): in "
                  f"turns (SDPA, shipped {label(SHIPPED)}, copy, copy, "
                  f"shipped, SDPA) {', '.join(f'{t:.3f}' for t in turns)} "
                  f"ms", flush=True)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
