"""Host scratch-buffer mpool — the hot-path memory component.

UCC's ``ucc_mc_cpu`` mpool (MPOOL_ELEM_SIZE / MPOOL_MAX_ELEMS behind the
``ucc_mpool_get`` scratch of every TL): collective algorithms must not
pay a fresh allocation on every post. The pool is size-classed —
power-of-two buckets of flat ``torch.uint8`` CPU tensors kept on
per-class free lists — and algorithms consume it through
:class:`ScratchLease`, a per-task set of leased buffers keyed by call
site that goes back to the pool when the task is finalized. The memory
is not pinned.

A persistent collective (init once, post many) then allocates nothing
in steady state: the first post leases (misses), and every later post
reuses the same lease without touching the pool.

Knobs (env wins over ``UCC_CONFIG_FILE``):

- ``UCC_MC_POOL_ENABLE`` (y): pooling on/off — off means every lease is
  a direct allocation (every ``get`` a miss). ``UCC_MC_POOL=n`` is an
  accepted shorthand.
- ``UCC_MC_POOL_MAX_ELEM_SIZE`` (64M): largest pooled bucket; bigger
  requests allocate directly and are never cached.
- ``UCC_MC_POOL_MAX_ELEMS`` (8): free-list cap per size class.
- ``UCC_MC_POOL_MAX_BYTES`` (256M): total cached-bytes cap across all
  classes; returns beyond it are dropped to the allocator.

Metrics: ``mc_pool_hit`` / ``mc_pool_miss`` counters and the
``mc_pool_bytes`` cached-bytes gauge (component ``mc``) when
``UCC_STATS`` is on; :meth:`HostMemPool.stats` gives the same numbers
unconditionally.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional

import torch

from ..constants import dt_torch
from ..obs import metrics
from ..utils.config import (Config, ConfigField, ConfigTable, parse_bool,
                            parse_memunits, parse_uint, register_table)

MC_POOL_CONFIG = register_table(ConfigTable(
    prefix="MC_POOL_", name="mc/pool", fields=[
        ConfigField("ENABLE", "y", "size-classed scratch mpool for host "
                    "collectives (UCC's ucc_mc_cpu mpool); off = every "
                    "scratch lease is a direct allocation. UCC_MC_POOL=n "
                    "is an accepted shorthand", parse_bool),
        ConfigField("MAX_ELEM_SIZE", "64M", "largest pooled bucket; bigger "
                    "requests bypass the pool (never cached)",
                    parse_memunits),
        ConfigField("MAX_ELEMS", "8", "free-list cap per size class "
                    "(UCC's MPOOL_MAX_ELEMS)", parse_uint),
        ConfigField("MAX_BYTES", "256M", "total cached-bytes cap across "
                    "all size classes", parse_memunits),
    ]))

#: buckets never go below this (keeps the class table small and lets a
#: tiny follow-up request reuse a prior tiny lease)
_MIN_BUCKET = 64


def _alloc(nbytes: int) -> torch.Tensor:
    return torch.empty(nbytes, dtype=torch.uint8)


class HostMemPool:
    """Size-classed free-list pool of flat ``torch.uint8`` CPU tensors.

    ``get(nbytes)`` returns a tensor whose capacity is the smallest
    power-of-two bucket >= nbytes; ``put`` must receive that same tensor
    (not a view) and files it back on its class free list.
    """

    def __init__(self, enable: bool = True,
                 max_elem_size: int = 64 << 20,
                 max_elems: int = 8,
                 max_bytes: int = 256 << 20):
        self.enable = enable
        self.max_elem_size = int(max_elem_size)
        self.max_elems = int(max_elems)
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._classes: Dict[int, List[torch.Tensor]] = {}
        self.hits = 0
        self.misses = 0
        self.cached_bytes = 0
        self.leased = 0          # live leases (get - put), diagnostic only

    @staticmethod
    def _bucket(nbytes: int) -> int:
        return max(_MIN_BUCKET, 1 << max(0, int(nbytes - 1).bit_length()))

    def get(self, nbytes: int) -> torch.Tensor:
        nbytes = max(1, int(nbytes))
        buf = None
        hit = False
        # admission is by BUCKET capacity, as in put(): a request whose
        # bucket rounds past max_elem_size goes direct, or every lease in
        # (bucket/2, max_elem_size] would miss forever on a bucket that
        # put() refuses to cache
        cap = self._bucket(nbytes)
        if self.enable and cap <= self.max_elem_size:
            with self._lock:
                lst = self._classes.get(cap)
                if lst:
                    buf = lst.pop()
                    self.cached_bytes -= cap
                    self.hits += 1
                    hit = True
                else:
                    self.misses += 1
                self.leased += 1
            if buf is None:
                buf = _alloc(cap)
        else:
            with self._lock:
                self.misses += 1
                self.leased += 1
            buf = _alloc(nbytes)
        if metrics.ENABLED:
            metrics.inc("mc_pool_hit" if hit else "mc_pool_miss",
                        component="mc")
        return buf

    def put(self, buf: torch.Tensor) -> None:
        cap = int(buf.numel())
        with self._lock:
            self.leased = max(0, self.leased - 1)
            if (self.enable and cap <= self.max_elem_size and
                    cap == self._bucket(cap)):
                lst = self._classes.setdefault(cap, [])
                if (len(lst) < self.max_elems and
                        self.cached_bytes + cap <= self.max_bytes):
                    lst.append(buf)
                    self.cached_bytes += cap
        if metrics.ENABLED:
            metrics.gauge("mc_pool_bytes", self.cached_bytes, component="mc")

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "cached_bytes": self.cached_bytes,
                    "cached_elems": sum(len(v)
                                        for v in self._classes.values()),
                    "leased": self.leased}

    def trim(self) -> None:
        """Drop every cached free-list element (memory pressure)."""
        with self._lock:
            self._classes.clear()
            self.cached_bytes = 0

    def reset_stats(self) -> None:
        with self._lock:
            self.hits = 0
            self.misses = 0


class ScratchLease:
    """A task's set of pool-leased scratch buffers, keyed by call site.

    ``get(key, shape, dtype)`` returns a typed view of a leased buffer;
    the same key on a later call (a persistent re-post, a pipelined
    fragment restart) reuses the lease in place when its capacity still
    fits — no pool traffic, no allocation. ``release()`` files every
    buffer back to the pool (idempotent); the owning task calls it from
    ``finalize_fn``, so a lease lives as long as its task.
    """

    __slots__ = ("_pool", "_bufs")

    def __init__(self, pool: HostMemPool):
        self._pool = pool
        self._bufs: Dict[Any, torch.Tensor] = {}

    def get(self, key: Any, shape, dtype) -> torch.Tensor:
        """A view of `shape` (an int or a tuple) and `dtype` (a torch
        dtype or a DataType) on the lease of `key`."""
        td = dtype if isinstance(dtype, torch.dtype) else dt_torch(dtype)
        if isinstance(shape, int):
            shape = (shape,)
        count = 1
        for s in shape:
            count *= int(s)
        nbytes = count * td.itemsize
        buf = self._bufs.get(key)
        if buf is None or buf.numel() < nbytes:
            if buf is not None:
                self._pool.put(buf)
            buf = self._bufs[key] = self._pool.get(nbytes)
        return buf[:nbytes].view(td).reshape(shape)

    def release(self) -> None:
        bufs, self._bufs = self._bufs, {}
        for buf in bufs.values():
            self._pool.put(buf)

    def __len__(self) -> int:
        return len(self._bufs)


# ---------------------------------------------------------------------------
# the process-wide pool (the MC/CPU component instance)
# ---------------------------------------------------------------------------

_global_pool: Optional[HostMemPool] = None
_global_lock = threading.Lock()


def _pool_from_env() -> HostMemPool:
    cfg = Config(MC_POOL_CONFIG)
    enable = bool(cfg.enable)
    shorthand = os.environ.get("UCC_MC_POOL", "").strip().lower()
    if shorthand:
        enable = shorthand not in ("0", "n", "no", "off", "false")
    return HostMemPool(enable=enable,
                       max_elem_size=cfg.max_elem_size,
                       max_elems=cfg.max_elems,
                       max_bytes=cfg.max_bytes)


def host_pool() -> HostMemPool:
    """The process-wide host scratch pool (made on first use from the
    environment)."""
    global _global_pool
    pool = _global_pool
    if pool is None:
        with _global_lock:
            pool = _global_pool
            if pool is None:
                pool = _global_pool = _pool_from_env()
    return pool


def reset_host_pool(pool: Optional[HostMemPool] = None) -> None:
    """Replace or clear the process-wide pool (embedders with their own
    caps)."""
    global _global_pool
    with _global_lock:
        _global_pool = pool
