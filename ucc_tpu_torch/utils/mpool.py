"""Object memory pool (UCC's ``ucc_mpool``, which wraps ucs_mpool and
adds a lock when the thread mode needs one).

The pool recycles Python objects (tasks, schedules, scratch buffers) so
that a progress loop allocates nothing; a ``threading.Lock`` is taken
only when the pool is made thread-safe.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional


class MPool:
    def __init__(self, obj_factory: Callable[[], Any],
                 obj_reset: Optional[Callable[[Any], None]] = None,
                 elems_per_chunk: int = 8, max_elems: int = -1,
                 thread_safe: bool = False, name: str = "mpool"):
        self._factory = obj_factory
        self._reset = obj_reset
        self._chunk = elems_per_chunk
        self._max = max_elems
        self._free: List[Any] = []
        self._lock = threading.Lock() if thread_safe else None
        self._allocated = 0
        self.name = name

    def get(self) -> Any:
        if self._lock:
            with self._lock:
                return self._get()
        return self._get()

    def _get(self) -> Any:
        if not self._free:
            grow = self._chunk
            if self._max >= 0:
                grow = min(grow, max(0, self._max - self._allocated))
            if grow == 0:
                grow = 1  # a soft cap: never fail as a hard ucs pool can
            for _ in range(grow):
                self._free.append(self._factory())
                self._allocated += 1
        return self._free.pop()

    def put(self, obj: Any) -> None:
        if self._reset:
            self._reset(obj)
        if self._lock:
            with self._lock:
                self._free.append(obj)
        else:
            self._free.append(obj)

    @property
    def num_allocated(self) -> int:
        return self._allocated

    @property
    def num_free(self) -> int:
        return len(self._free)
