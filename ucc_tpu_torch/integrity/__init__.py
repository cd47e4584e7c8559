"""End-to-end data integrity: wire checksums, result attestation, and
corrupting-rank quarantine (``UCC_INTEGRITY=off|wire|verify``; the port
of the JAX package's ``integrity/``).

Fault tolerance (health/agree/shrink/grow) handles ranks that *stop*;
this subsystem handles ranks that *lie*: silent data corruption, where a
flipped bit in a transport buffer poisons every downstream reduction
without any rank noticing. Three escalating modes:

- **off** (default): zero cost. No knob is read on any hot path; the
  bindings below are module-level booleans tested before any work, so
  candidate lists, dispatch and the native entry path are unchanged with
  the subsystem off (regression-asserted).
- **wire**: a per-message crc32 computed at send and verified at
  delivery in BOTH matchers. The Python ``Mailbox`` carries it in the
  match metadata; the native core carries a checksum word in the entry
  header with C-side compute/verify on push/delivery (covering
  plan-executor rounds); the arena and tl/sockets' frames carry
  ``(1 << 32) | crc32``, 0 meaning none. A mismatch fails the
  collective with ``Status.ERR_DATA_CORRUPTED`` naming the sender,
  increments ``integrity_wire_mismatch``, and feeds
  ``HealthRegistry.suspect(source="integrity")``.
- **verify**: wire mode plus sampled cross-rank result attestation: at
  a deterministic post-index cadence (``UCC_INTEGRITY_SAMPLE``) ranks
  exchange a crc32 digest of the completed result of bitwise
  rank-invariant collectives (allreduce / allgather / bcast) on HOST
  memory over the service team's ``TransportOob``. A minority digest
  NAMES the corruptor; ``UCC_INTEGRITY_STRIKES`` offenses escalate into
  **quarantine**: the offender is marked failed in the health registry,
  so the next ``Team.shrink`` excludes it like a dead rank. A
  quarantined rank may rejoin through ``Team.join``.

Detection raises :class:`~ucc_tpu_torch.status.DataCorruptedError` on
every surviving rank of the sampled collective, carrying ``ranks`` (the
attributed corruptors) and ``quarantine`` (the subset whose strike
budget is exhausted).

Threat model: accidental corruption (bit flips, scribbles, torn copies).
crc32 is not cryptographic; the goal is attribution and containment of
broken hosts, not consensus against adversaries.
"""
from __future__ import annotations

import struct
import time
import zlib
from collections import Counter
from typing import Optional

from ..constants import CollType, dt_size
from ..status import DataCorruptedError, Status
from ..utils.config import (ConfigField, ConfigTable, parse_string,
                            parse_uint, register_table)
from ..utils.log import get_logger

logger = get_logger("integrity")

_INTEGRITY_CONFIG = register_table(ConfigTable(
    prefix="", name="integrity", fields=[
        ConfigField("INTEGRITY", "off",
                    "end-to-end data integrity mode: off = zero cost "
                    "(hot paths byte-identical); wire = per-message "
                    "crc32 computed at send and verified at delivery in "
                    "both matchers, a mismatch raises "
                    "ERR_DATA_CORRUPTED naming the sender; verify = "
                    "wire plus sampled cross-rank result attestation "
                    "with minority attribution and strike-based "
                    "quarantine of repeat corruptors", parse_string),
        ConfigField("INTEGRITY_SAMPLE", "16",
                    "verify-mode attestation cadence: every Nth "
                    "eligible collective per team (deterministic "
                    "post-index, identical on every rank) exchanges a "
                    "result digest over the service team", parse_uint),
        ConfigField("INTEGRITY_STRIKES", "3",
                    "attested offenses before a corrupting rank is "
                    "quarantined (marked failed in the health registry "
                    "so the next shrink excludes it like a dead rank)",
                    parse_uint),
    ]))


def _resolve_knobs():
    from ..utils.config import Config
    try:
        cfg = Config(_INTEGRITY_CONFIG)
        mode = str(cfg.integrity).strip().lower()
        if mode in ("", "0", "n", "no", "false"):
            mode = "off"
        if mode not in ("off", "wire", "verify"):
            logger.warning("UCC_INTEGRITY=%s not in off|wire|verify; "
                           "treating as off", mode)
            mode = "off"
        sample = max(1, int(cfg.integrity_sample) or 16)
        strikes = max(1, int(cfg.integrity_strikes) or 3)
        return mode, sample, strikes
    except Exception:  # noqa: BLE001 - knob resolution must never break import
        return "off", 16, 3


MODE, SAMPLE, STRIKES = _resolve_knobs()
#: module-level booleans, read at binding sites only (never per message)
ENABLED = MODE != "off"
WIRE = ENABLED            # wire crc is on in both wire and verify modes
VERIFY = MODE == "verify"

#: collectives whose completed result is bitwise identical on every rank
#: (the attestation precondition). Reductions qualify because the
#: algorithms commit to a fixed reduction ORDER across ranks; quantized
#: variants qualify because the codec is deterministic on every rank.
ATTEST_COLLS = CollType.ALLREDUCE | CollType.ALLGATHER | CollType.BCAST

#: digest-exchange wire format: (crc32, contributor ctx rank)
_DIGEST = struct.Struct("!Iq")

#: attestation exchange deadline: generous (it rides the same transport
#: as the collectives themselves); on expiry the check is abandoned with
#: a warning, never wedging the caller's test() loop
ATTEST_TIMEOUT = 60.0


def configure(mode: Optional[str] = None, sample: Optional[int] = None,
              strikes: Optional[int] = None) -> None:
    """Runtime (re)configuration (tests/embedders; env read at import)."""
    global MODE, ENABLED, WIRE, VERIFY, SAMPLE, STRIKES
    if mode is not None:
        if mode not in ("off", "wire", "verify"):
            raise ValueError(f"integrity mode must be off|wire|verify, "
                             f"got {mode!r}")
        MODE = mode
        ENABLED = MODE != "off"
        WIRE = ENABLED
        VERIFY = MODE == "verify"
    if sample is not None:
        SAMPLE = max(1, int(sample))
    if strikes is not None:
        STRIKES = max(1, int(strikes))


def reset() -> None:
    """Re-resolve from the environment (tests)."""
    global MODE, ENABLED, WIRE, VERIFY, SAMPLE, STRIKES
    MODE, SAMPLE, STRIKES = _resolve_knobs()
    ENABLED = MODE != "off"
    WIRE = ENABLED
    VERIFY = MODE == "verify"


# ---------------------------------------------------------------------------
# checksums
# ---------------------------------------------------------------------------

def payload_crc(data) -> int:
    """crc32 of a payload (numpy array / memoryview / bytes / CPU tensor,
    anything with a buffer). Matches the native core's table (zlib
    polynomial), so a python-matcher send verifies against a C-matcher
    delivery."""
    try:
        return zlib.crc32(data) & 0xFFFFFFFF
    except (TypeError, ValueError, BufferError):
        import torch
        if isinstance(data, torch.Tensor):
            from ..mc.cpu import _as_u8
            return zlib.crc32(_as_u8(data.contiguous())) & 0xFFFFFFFF
        import numpy as np
        return zlib.crc32(np.ascontiguousarray(data).tobytes()) & 0xFFFFFFFF


def _result_crc(args) -> int:
    """Digest of a completed collective's result buffer. The result
    lands in dst for allreduce/allgather and (by this tree's bcast
    convention) in src on every rank for bcast. A CPU tensor is digested
    through its byte view (a bf16 tensor has no numpy dtype)."""
    bi = args.dst if args.dst is not None else args.src
    buf = bi.buffer
    nbytes = int(bi.count) * dt_size(bi.datatype)
    import torch
    if isinstance(buf, torch.Tensor):
        from ..mc.cpu import _as_u8
        view = memoryview(_as_u8(buf.contiguous()))
    else:
        try:
            view = memoryview(buf).cast("B")
        except TypeError:
            import numpy as np
            view = memoryview(np.ascontiguousarray(buf)).cast("B")
    return zlib.crc32(view[:nbytes]) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# strike ledger (per context, keyed by offender ctx rank)
# ---------------------------------------------------------------------------

def _ledger(context) -> dict:
    led = getattr(context, "_integrity_strikes", None)
    if led is None:
        led = {}
        context._integrity_strikes = led
    return led


def add_strike(context, ctx_rank: int) -> int:
    led = _ledger(context)
    led[int(ctx_rank)] = n = led.get(int(ctx_rank), 0) + 1
    return n


def strikes(context, ctx_rank: int) -> int:
    return _ledger(context).get(int(ctx_rank), 0)


def clear_strikes(context, ctx_rank: Optional[int] = None) -> None:
    """Forgive: the rejoin path (Team.join admits a quarantined rank
    back) clears its ledger so one pre-repair strike cannot instantly
    re-quarantine the repaired host."""
    if ctx_rank is None:
        _ledger(context).clear()
    else:
        _ledger(context).pop(int(ctx_rank), None)


# ---------------------------------------------------------------------------
# wire-mismatch reporting (both matchers route detection here)
# ---------------------------------------------------------------------------

def note_wire_mismatch(context, src_ctx: Optional[int],
                       detail: str = "") -> None:
    """Record a delivery-side crc mismatch attributed to sender
    *src_ctx* (None / negative when the matcher could not attribute):
    counts ``integrity_wire_mismatch``, leaves watchdog + flight
    evidence, feeds the health registry's suspect lane, and adds a
    strike. The caller raises DataCorruptedError separately."""
    from ..obs import flight, metrics, watchdog
    src = int(src_ctx) if src_ctx is not None and int(src_ctx) >= 0 else None
    logger.error("wire integrity failure%s%s",
                 f" from ctx rank {src}" if src is not None else "",
                 f": {detail}" if detail else "")
    if metrics.ENABLED:
        metrics.inc("integrity_wire_mismatch", component="integrity")
    watchdog.note_integrity("wire_mismatch",
                            [src] if src is not None else [], detail)
    flight.on_integrity("wire_mismatch", src if src is not None else -1,
                        detail)
    if src is None:
        return
    n = add_strike(context, src)
    reg = getattr(context, "health", None)
    if reg is not None:
        try:
            reg.suspect(src, source="integrity")
        except Exception:  # noqa: BLE001 - attribution is best-effort
            pass
    # verify mode escalates WIRE strikes into quarantine too: a wire-
    # detected corruption fails the collective before it could ever be
    # attested, so without this a persistent corruptor whose garbage is
    # always caught at delivery would strike forever and never be
    # excluded. Wire-only mode stops at detection (no membership
    # authority without the verify-mode agreement machinery).
    if VERIFY and n >= STRIKES:
        _quarantine(context, src, detail or "repeated wire crc mismatch")


# ---------------------------------------------------------------------------
# sampled result attestation (verify mode)
# ---------------------------------------------------------------------------

def attest_due(team) -> Optional[int]:
    """Deterministic sampling decision, made at collective_init for
    eligible collectives ONLY (every eligibility predicate is rank-
    invariant, so the per-team counter ticks identically everywhere and
    all members of a sampled collective agree to attest). Returns the
    sample sequence number when due, else None."""
    seq = getattr(team, "_integrity_seq", 0)
    team._integrity_seq = seq + 1
    return seq if seq % SAMPLE == 0 else None


class _Attest:
    """Per-request attestation state driven nonblockingly from
    ``CollRequest.test()``: the exchange starts when the underlying
    task first tests OK, and test() keeps returning IN_PROGRESS until
    every member's digest arrived (the TransportOob polling contract:
    each rank's caller keeps polling its own request)."""

    __slots__ = ("seq", "rq", "deadline")

    def __init__(self, seq: int):
        self.seq = seq
        self.rq = None
        self.deadline = 0.0


def bind(req, team) -> None:
    """Attach attestation to an eligible sampled request (called from
    collective_init under ``if integrity.VERIFY:``)."""
    seq = attest_due(team)
    if seq is not None:
        req._attest = _Attest(seq)


def attest_test(req) -> Status:
    """Drive *req*'s attestation. Returns IN_PROGRESS while the digest
    exchange is pending, OK when the digests agreed (or the check was
    abandoned), and raises DataCorruptedError on a mismatch."""
    a = req._attest
    team = req.team
    ctx = team.context
    if a.rq is None and not _attest_start(req, a, team, ctx):
        return Status.OK
    try:
        st = a.rq.test()
    except Exception as e:  # noqa: BLE001 - a torn-down transport mid-
        # exchange abandons the check, never wedges the caller
        logger.warning("integrity attestation exchange failed: %s", e)
        req._attest = None
        return Status.OK
    if st == Status.IN_PROGRESS:
        if time.monotonic() > a.deadline:
            logger.warning(
                "integrity attestation timed out after %.0fs (team %s "
                "sample %d); abandoning this check", ATTEST_TIMEOUT,
                team.id, a.seq)
            req._attest = None
            return Status.OK
        return Status.IN_PROGRESS
    req._attest = None
    return _attest_finish(req, a, team, ctx)


def _attest_start(req, a: _Attest, team, ctx) -> bool:
    """Post the digest allgather among members not known dead (the
    FlightCollection liveness filter: a killed member must not wedge
    the exchange). Returns False when the check cannot run here."""
    svc = team.service_team
    if svc is None or getattr(svc, "transport", None) is None:
        req._attest = None
        return False
    try:
        crc = _result_crc(req.args)
    except Exception as e:  # noqa: BLE001 - an undigestable buffer
        # (exotic buffer type) skips the check rather than failing a
        # collective that actually completed
        logger.warning("integrity digest failed: %s", e)
        req._attest = None
        return False
    from ..core.oob import TransportOob
    from ..fault import inject as fault
    dead_ctx = set()
    reg = getattr(ctx, "health", None)
    if reg is not None:
        dead_ctx |= reg.dead_set()
    if fault.ENABLED:
        dead_ctx |= {r for r in fault.SPEC.kill}
    member_ctx = [int(team.ctx_map.eval(r)) for r in range(team.size)]
    live = [c for c in member_ctx if c not in dead_ctx]
    if len(live) < 2 or ctx.rank not in live:
        req._attest = None
        return False
    try:
        oob = TransportOob(svc.comp_context, svc.transport, live, ctx.rank,
                           ("integrity", team.team_key, a.seq), team.epoch)
        a.rq = oob.allgather(_DIGEST.pack(crc, ctx.rank))
    except Exception as e:  # noqa: BLE001
        logger.warning("integrity attestation post failed: %s", e)
        req._attest = None
        return False
    a.deadline = time.monotonic() + ATTEST_TIMEOUT
    return True


def _attest_finish(req, a: _Attest, team, ctx) -> Status:
    from ..obs import flight, metrics, watchdog
    digests = []
    for b in a.rq.result:
        if len(b) >= _DIGEST.size:
            digests.append(_DIGEST.unpack(b[:_DIGEST.size]))
    if metrics.ENABLED:
        metrics.inc("integrity_digest_checks", component="integrity",
                    coll=getattr(req.task, "coll_name", "") or "")
    tally = Counter(crc for crc, _ in digests)
    if len(tally) <= 1:
        return Status.OK
    # mismatch: majority digest wins; the minority NAMES the corruptor.
    # A tie has no majority: detected but unattributed.
    top = tally.most_common(2)
    majority_crc, majority_n = top[0]
    unattributed = top[1][1] == majority_n
    offenders = [] if unattributed else \
        sorted(int(r) for crc, r in digests if crc != majority_crc)
    detail = (f"team {team.id} sample {a.seq} "
              f"coll {getattr(req.task, 'coll_name', '?')}: "
              f"{len(tally)} distinct digests over {len(digests)} ranks")
    logger.error("result attestation mismatch: %s%s", detail,
                 f" -> corruptor ctx rank(s) {offenders}" if offenders
                 else " (no majority; unattributed)")
    if metrics.ENABLED:
        metrics.inc("integrity_digest_mismatch", component="integrity")
    watchdog.note_integrity("digest_mismatch", offenders, detail)
    quarantined = []
    reg = getattr(ctx, "health", None)
    for r in offenders:
        flight.on_integrity("digest_mismatch", r, detail)
        n = add_strike(ctx, r)
        if reg is not None:
            try:
                reg.suspect(r, source="integrity")
            except Exception:  # noqa: BLE001
                pass
        if n >= STRIKES:
            quarantined.append(r)
    for r in quarantined:
        _quarantine(ctx, r, detail)
    raise DataCorruptedError(
        "collective result attestation failed"
        + ("" if offenders else " (no majority digest; unattributed)"),
        ranks=offenders, quarantine=quarantined)


def _quarantine(ctx, offender: int, detail: str) -> None:
    """Strike budget exhausted: mark *offender* failed in the health
    registry (skipping our own rank: the corruptor learns its fate
    from the DataCorruptedError's quarantine set), so the next
    Team.shrink's FtAgreement flood excludes it exactly like a dead
    rank. Rejoinable later via Team.join + clear_strikes."""
    from ..obs import flight, metrics, watchdog
    logger.error("quarantining corrupting ctx rank %d after %d strikes "
                 "(%s)", offender, strikes(ctx, offender), detail)
    if metrics.ENABLED:
        metrics.inc("integrity_quarantines", component="integrity")
    watchdog.note_integrity("quarantine", [offender], detail)
    flight.on_integrity("quarantine", offender, detail)
    if offender == ctx.rank:
        return
    reg = getattr(ctx, "health", None)
    if reg is not None:
        try:
            reg.report_failure(offender, "integrity",
                               f"quarantined after repeated data "
                               f"corruption: {detail}")
        except Exception:  # noqa: BLE001
            pass
