"""The injector: probabilistic drop/delay/error/corrupt/rank-kill,
seeded.

Two injection boundaries, the two places every host collective passes:

- **transport boundary** (tl/host/task.py ``send_nb``/``recv_nb``):
  ``send_action()`` may drop the message (a pre-completed request, so
  the sender proceeds while the receiver starves: the lost-packet hang
  the cancellation layer must bound), delay its delivery (the real send
  fires from ``progress()`` once due), or fail the post outright.
  ``recv_action()`` only errors (losing a recv is dropping its send).
- **task boundary** (schedule/task.py ``CollTask.post``):
  ``post_inject()`` may fail a task before it touches the wire (the
  shape the runtime score-map fallback retries) and fails every post of
  a killed rank.

Determinism: one ``random.Random(UCC_FAULT_SEED)`` drives every
decision, so a drill replays identically under the same seed and spec,
and the same spec and seed give the same sequence of decisions as the
JAX package's injector. Everything is cold unless ``UCC_FAULT`` is set:
call sites test ``inject.ENABLED`` (a module-level boolean) first.
"""
from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Set, Tuple

from ..status import Status


@dataclass
class FaultSpec:
    """Parsed ``UCC_FAULT`` spec."""

    drop: float = 0.0          # P(send dropped)
    delay: float = 0.0         # P(send delayed)
    delay_s: float = 0.0       # delay duration
    delay_rank: Optional[int] = None   # pin delays to one ctx rank
    error: float = 0.0         # P(send/recv post fails)
    post_error: float = 0.0    # P(task post fails before wire traffic)
    kill: Set[int] = field(default_factory=set)   # dead ctx ranks
    corrupt: float = 0.0       # P(send payload bit-flipped in flight)
    corrupt_rank: Optional[int] = None  # pin corruption to one ctx rank

    @property
    def active(self) -> bool:
        return bool(self.drop or self.delay or self.error
                    or self.post_error or self.kill or self.corrupt)


def parse_spec(s: str) -> FaultSpec:
    """Parse ``drop=P,delay=P:S,delay_rank=R,error=P,post_error=P,
    kill=R[+R..],corrupt=P,corrupt_rank=R``. ``delay_rank`` pins send
    delays to one ctx rank — the controlled-straggler drill the
    flight-recorder diagnosis smoke uses (a known culprit the diagnosis
    must name); ``corrupt_rank`` likewise pins payload bit-flips to one
    sender (the controlled-corruptor drill). Unknown keys raise:
    a typo'd fault drill that silently injects nothing would report a
    no-hang pass it never earned."""
    spec = FaultSpec()
    s = (s or "").strip()
    if not s or s.lower() in ("n", "no", "off", "0"):
        return spec
    for tok in s.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if "=" not in tok:
            raise ValueError(f"invalid UCC_FAULT token '{tok}'")
        k, v = tok.split("=", 1)
        k = k.strip().lower()
        if k == "drop":
            spec.drop = float(v)
        elif k == "delay":
            if ":" in v:
                p, d = v.split(":", 1)
                spec.delay, spec.delay_s = float(p), float(d)
            else:
                spec.delay, spec.delay_s = float(v), 0.001
        elif k == "delay_rank":
            spec.delay_rank = int(v)
        elif k == "error":
            spec.error = float(v)
        elif k == "post_error":
            spec.post_error = float(v)
        elif k == "kill":
            spec.kill = {int(r) for r in v.split("+") if r.strip() != ""}
        elif k == "corrupt":
            spec.corrupt = float(v)
        elif k == "corrupt_rank":
            spec.corrupt_rank = int(v)
        else:
            raise ValueError(f"unknown UCC_FAULT key '{k}'")
    for p in (spec.drop, spec.delay, spec.error, spec.post_error,
              spec.corrupt):
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"UCC_FAULT probability {p} out of [0,1]")
    return spec


# ---------------------------------------------------------------------------
# module state (env-driven at import; configure() for tests/embedders)
# ---------------------------------------------------------------------------

SPEC: FaultSpec = FaultSpec()
ENABLED: bool = False
_rng = random.Random(0)
_lock = threading.Lock()
#: deferred deliveries: (due_monotonic, thunk)
_pending: List[Tuple[float, Callable[[], None]]] = []
#: decision counters (diagnostics + soak reports; not the metrics
#: registry — injection must work with UCC_STATS off)
COUNTS = {"drop": 0, "delay": 0, "error": 0, "post_error": 0, "kill": 0,
          "corrupt": 0}


def configure(spec: str = "", seed: Optional[int] = None) -> None:
    """Runtime (re)configuration. Empty spec disables. Reseeds the RNG
    so a configure() call is a deterministic replay point."""
    global SPEC, ENABLED, _rng
    SPEC = parse_spec(spec) if isinstance(spec, str) else spec
    ENABLED = SPEC.active
    _rng = random.Random(0 if seed is None else seed)
    with _lock:
        _pending.clear()
    for k in COUNTS:
        COUNTS[k] = 0


def reset() -> None:
    """Disable injection and drop all deferred deliveries (tests)."""
    configure("")


def pause() -> bool:
    """Temporarily stop injecting (e.g. while a soak harness re-creates
    a poisoned team); returns the previous enabled state for restore()."""
    global ENABLED
    prev = ENABLED
    ENABLED = False
    return prev


def restore(prev: bool) -> None:
    global ENABLED
    ENABLED = prev and SPEC.active


# ---------------------------------------------------------------------------
# decisions — called only under `if inject.ENABLED:`
# ---------------------------------------------------------------------------

def killed(ctx_rank: Optional[int]) -> bool:
    return ctx_rank is not None and ctx_rank in SPEC.kill


def send_action(ctx_rank: Optional[int] = None):
    """Decide the fate of one send. Returns None (deliver normally),
    "drop", "error", or ("delay", seconds)."""
    if killed(ctx_rank):
        COUNTS["kill"] += 1
        return "drop"
    r = _rng.random()
    if r < SPEC.drop:
        COUNTS["drop"] += 1
        return "drop"
    r -= SPEC.drop
    if r < SPEC.error:
        COUNTS["error"] += 1
        return "error"
    r -= SPEC.error
    if r < SPEC.delay and (SPEC.delay_rank is None or
                           ctx_rank == SPEC.delay_rank):
        COUNTS["delay"] += 1
        return ("delay", SPEC.delay_s)
    return None


def corrupt_action(ctx_rank: Optional[int] = None) -> bool:
    """Decide whether THIS send's payload gets corrupted. Independent of
    the drop/error/delay lottery (a corrupted message still arrives —
    that is the whole point: silent unless integrity checking catches
    it). ``corrupt_rank`` pins the fault to one sender, the
    controlled-corruptor drill the attestation attribution test needs."""
    if not SPEC.corrupt:
        return False
    if SPEC.corrupt_rank is not None and ctx_rank != SPEC.corrupt_rank:
        return False
    if _rng.random() < SPEC.corrupt:
        COUNTS["corrupt"] += 1
        return True
    return False


def corrupt_send(data):
    """Apply the corruption: one seeded bit flip in a COPY of the send
    payload. Returns ``(corrupted_u8_array, clean_crc)`` where
    *clean_crc* is the crc32 of the ORIGINAL bytes — handed to the
    matcher as the send-side checksum, so the injection models
    corruption IN FLIGHT (after the sender checksummed correct data),
    the only kind a wire crc can catch. Zero-length payloads are
    returned unchanged (nothing to flip)."""
    import zlib

    import numpy as np
    u8 = np.frombuffer(data, dtype=np.uint8) if not isinstance(
        data, np.ndarray) else np.ascontiguousarray(data).view(np.uint8)
    u8 = u8.reshape(-1)
    clean_crc = zlib.crc32(u8) & 0xFFFFFFFF
    if u8.size == 0:
        return u8, clean_crc
    out = u8.copy()
    i = _rng.randrange(out.size)
    out[i] ^= 1 << _rng.randrange(8)
    return out, clean_crc


def recv_action(ctx_rank: Optional[int] = None):
    """Decide the fate of one recv post: None or "error"."""
    if _rng.random() < SPEC.error:
        COUNTS["error"] += 1
        return "error"
    return None


def post_inject(task) -> Optional[Status]:
    """Task-boundary injection: returns an error Status to fail the task
    at post (before any wire traffic), or None to proceed. Killed ranks
    fail every post — the local half of simulating a dead process; the
    remote half is their sends being dropped."""
    rank = _task_ctx_rank(task)
    if killed(rank):
        COUNTS["kill"] += 1
        return Status.ERR_NO_MESSAGE
    if SPEC.post_error and not getattr(task, "flags_internal", False) \
            and task.schedule is None and _rng.random() < SPEC.post_error:
        # top-level tasks only: failing one child of a live schedule
        # tests the error cascade, but failing the task pre-post is the
        # runtime-fallback shape this hook exists to exercise
        COUNTS["post_error"] += 1
        return Status.ERR_NO_RESOURCE
    return None


def _task_ctx_rank(task) -> Optional[int]:
    team = getattr(task, "team", None)
    core = getattr(team, "core_team", team)
    ctx = getattr(core, "context", None)
    return getattr(ctx, "rank", None)


# ---------------------------------------------------------------------------
# deferred delivery (the "delay" action)
# ---------------------------------------------------------------------------

class DelayedSendReq:
    """Proxy returned for a delayed send: pending until the deferred
    thunk installs the real request."""

    __slots__ = ("real", "cancelled")

    def __init__(self):
        self.real = None
        self.cancelled = False

    def test(self) -> bool:
        if self.cancelled:
            return True
        return bool(self.real is not None and self.real.test())

    @property
    def error(self):
        return getattr(self.real, "error", None) if self.real is not None \
            else None

    def cancel(self) -> None:
        self.cancelled = True
        c = getattr(self.real, "cancel", None)
        if c is not None:
            c()


def defer(delay_s: float, thunk: Callable[[], None]) -> None:
    with _lock:
        _pending.append((time.monotonic() + delay_s, thunk))


def progress(now: Optional[float] = None) -> int:
    """Release due deferred deliveries; called from the progress queue
    under `if inject.ENABLED:`. Returns the number released."""
    if not _pending:
        return 0
    if now is None:
        now = time.monotonic()
    with _lock:
        due = [t for t in _pending if t[0] <= now]
        if not due:
            return 0
        _pending[:] = [t for t in _pending if t[0] > now]
    for _, thunk in due:
        try:
            thunk()
        except Exception:  # noqa: BLE001 - a late delivery into a torn-down
            # endpoint must not kill the caller's progress loop
            pass
    return len(due)


# env-driven arming (import time, like obs.metrics / obs.watchdog)
_env_spec = os.environ.get("UCC_FAULT", "")
if _env_spec:
    try:
        _seed = int(os.environ.get("UCC_FAULT_SEED", "0") or 0)
    except ValueError:
        _seed = 0
    try:
        configure(_env_spec, _seed)
    except ValueError:
        from ..utils.log import get_logger
        get_logger("fault").exception("invalid UCC_FAULT spec %r — "
                                      "injection DISABLED", _env_spec)
