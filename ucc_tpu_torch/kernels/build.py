"""Build and load the package's CUDA kernels.

Each source under ``ucc_tpu_torch/csrc/`` is compiled by ``nvcc`` into a
shared library with a plain C interface and loaded through ``ctypes``. The
libraries go into ``ucc_tpu_torch/build/`` (listed in ``.gitignore``),
named by a hash of the flags, the source and every header of ``csrc/`` it
includes, so an edited source or header is rebuilt and an unchanged one is
not. Builds of several sources run in parallel,
one ``nvcc`` each. Nothing is built when a module is imported: the first
launch builds what it needs, or ``build_all()`` builds everything up
front. A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

#: no --use_fast_math: AVG's division and NaN handling must stay IEEE
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        if cand and os.path.isfile(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH): the CUDA kernels "
                           "cannot be built")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _source_files(source: str) -> List[str]:
    """*source* and every ``#include "..."`` of ``csrc/`` it reaches, each
    once, in the order first met."""
    seen: List[str] = []
    todo = [source]
    while todo:
        name = todo.pop(0)
        if name in seen:
            continue
        seen.append(name)
        with open(os.path.join(CSRC, name), "rb") as fh:
            todo += [m.decode() for m in _INCLUDE.findall(fh.read())]
    return seen


def _lib_path(source: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _source_files(source):
        with open(os.path.join(CSRC, name), "rb") as fh:
            digest.update(name.encode() + b"\0" + fh.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")


def build_all(sources: Sequence[str],
              reports: Optional[Dict[str, str]] = None) -> float:
    """Compile every source that has no up-to-date library, all nvcc
    processes started together. Returns the wall seconds spent. With a
    *reports* dict, nvcc also prints ptxas's resource report (``-Xptxas
    -v``: registers, stack frame and spills per kernel instance) and each
    compiled source's output lands under its name; a source whose library
    was already built is not compiled and has none."""
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = [(s, _lib_path(s)) for s in sources
            if not os.path.isfile(_lib_path(s))]
    if todo:
        nvcc = nvcc_path()
        procs: List = []
        for src, out in todo:
            tmp = f"{out}.{os.getpid()}.tmp"
            verbose = ["-Xptxas", "-v"] if reports is not None else []
            cmd = [nvcc, *NVCC_FLAGS, *verbose, "-o", tmp,
                   os.path.join(CSRC, src)]
            procs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for src, out, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src}:\n{log.decode(errors='replace')}")
                continue
            os.replace(tmp, out)   # atomic: readers never see a partial .so
            if reports is not None:
                reports[src] = log.decode(errors="replace")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(source: str) -> ctypes.CDLL:
    """The loaded library of *source*, building it first if needed."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            build_all([source])
            lib = _loaded[source] = ctypes.CDLL(_lib_path(source))
        return lib
