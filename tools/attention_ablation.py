"""Where the time of the tensor-core attention kernel goes, on the GPU.

The profilers that split a kernel's time (ncu, nsys) are not always at hand,
so this tool takes the kernel apart instead: it compiles copies of
``csrc/ring_flash_attn.cu`` with one piece of work cut out by a text
substitution, and times each copy against the whole kernel in turns at the
GQA block's shapes (8 ranks x 1024 rows, 32 query heads over 8 K/V heads,
head dim 128, bf16, causal). A cut copy computes wrong results: only its
time is read. The pieces:

- ``no_pv``: both P·V products (the tensor cores' larger half);
- ``no_lo``: the lo half of P (the second P·V wgmma);
- ``no_s``: S = Q·Kᵀ (the scores stay zero);
- ``no_mma``: every wgmma, so what remains is the copies and the softmax;
- ``loads_only``: the consumers wait for each tile and release it, nothing
  more, so what remains is the producer's copies;
- ``cp_async`` and ``cp_async_loads_only``: the whole kernel and its copies
  alone with K/V by 16-byte ``cp.async`` instead of TMA, so the two ways of
  loading a tile are timed against each other.

Run on a machine with a CUDA GPU and nvcc:

    python tools/attention_ablation.py [--reps 20] [--turns 3]

It prints one line per turn and copy (ms, difference to the whole kernel)
and the card's name and power limit. Nothing of the package calls it.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from typing import Dict, List, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

S_CALL = """        if constexpr (kQRegs)
          Tc<T>::template rs<0>(sc, qf[kk], sw128_desc(kt + off, 16, 1024),
                                kk > 0);"""
NO_S = ("        if constexpr (kQRegs) {\n"
        "          if (kk == 0)\n"
        "            for (int e = 0; e < 32; ++e) sc[e] = 0.f;\n"
        "        }")
NO_LO = [("Tc<T>::template rs<1>(o[p], lo, vd, 1);", "")]
NO_PV = NO_LO + [("Tc<T>::template rs<1>(o[p], hi, vd, 1);", "")]
LOADS_AFTER = 'asm volatile("bar.sync %0, 128;\\n" ::"r"(1 + wg) : "memory");'
LOADS_ONLY = LOADS_AFTER + """
    for (int i = 0; i < walk.count; ++i) {
      mbar_wait(smem_addr(&full[i % STAGES]), (i / STAGES) & 1);
      mbar_arrive(smem_addr(&empty[i % STAGES]));
    }
    if (walk.count >= 0) return;"""
TMA_ROUTE = "  if (a.d != 64 && a.d != 128 && a.d != 256)\n"
CP_ASYNC = [(TMA_ROUTE, "  if (true)\n")]

#: copy name -> the (text, replacement) pairs that cut its piece out
CUTS: Dict[str, List[Tuple[str, str]]] = {
    "whole": [],
    "no_pv": NO_PV,
    "no_lo": NO_LO,
    "no_s": [(S_CALL, NO_S)],
    "no_mma": NO_PV + [(S_CALL, NO_S)],
    "loads_only": [(LOADS_AFTER, LOADS_ONLY)],
    "cp_async": CP_ASYNC,
    "cp_async_loads_only": CP_ASYNC + [(LOADS_AFTER, LOADS_ONLY)],
}


def build_copies(out_dir: str) -> Dict[str, ctypes.CDLL]:
    """Every copy compiled in parallel (one nvcc each) and loaded."""
    from ucc_tpu_torch.kernels import build, ring_attention as ka
    with open(os.path.join(build.CSRC, ka.SOURCE)) as fh:
        source = fh.read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, cuts in CUTS.items():
        text = source
        for old, new in cuts:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the kernel no longer has "
                                   f"{old.strip()[:60]!r} once")
            text = text.replace(old, new)
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as fh:
            fh.write(text)
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
             os.path.join(out_dir, f"lib{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
        lib.ucc_ring_flash_attn.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        lib.ucc_ring_flash_attn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--turns", type=int, default=3)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("attention_ablation: no CUDA device", file=sys.stderr)
        return 2
    from ucc_tpu_torch.kernels import build, ring_attention as ka
    libs = build_copies(os.path.join(build.BUILD_DIR, "ablation"))
    n, h, h_kv, s, d = 8, 32, 8, 1024, 128
    g = torch.Generator(device="cuda").manual_seed(1)
    qs, ks, vs = ([torch.randn(heads, s, d, generator=g, device="cuda")
                   .bfloat16() for _ in range(n)] for heads in (h, h_kv, h_kv))
    outs = [torch.empty_like(q) for q in qs]
    ptrs = (ctypes.c_void_p * (4 * n))(
        *[t.data_ptr() for t in (*qs, *ks, *vs, *outs)])
    scale = ka.default_scale(d)

    def launch(lib):
        rc = lib.ucc_ring_flash_attn(
            ka.DTYPE_CODES[torch.bfloat16], ptrs, n, h, h_kv, s, d, scale, 1,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    def device_ms(lib) -> float:
        launch(lib)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        torch.cuda._sleep(100_000_000)     # the host enqueues behind it
        start.record()
        for _ in range(args.reps):
            launch(lib)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    for turn in range(args.turns):
        whole = device_ms(libs["whole"])
        print(f"turn {turn} {'whole':19s} {whole:.3f} ms", flush=True)
        for name, lib in libs.items():
            if name != "whole":
                ms = device_ms(lib)
                print(f"turn {turn} {name:19s} {ms:.3f} ms "
                      f"({ms - whole:+.3f})", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
