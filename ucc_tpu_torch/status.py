"""Status codes for ucc_tpu_torch.

The same tri-state contract as UCC's ucc_status_t: OK /
OPERATION_INITIALIZED / IN_PROGRESS are non-errors, everything below zero
is an error. An IntEnum plus an exception type, so call sites can either
poll (UCC-style nonblocking test) or raise. The integer values are those
of ``ucc_tpu.status.Status``.
"""
from __future__ import annotations

import enum


class Status(enum.IntEnum):
    """Operation status. Mirrors ucc_status_t semantics."""

    # Non-error statuses
    OK = 0
    IN_PROGRESS = 1
    OPERATION_INITIALIZED = 2

    # Error statuses
    ERR_NOT_SUPPORTED = -1
    ERR_NOT_IMPLEMENTED = -2
    ERR_INVALID_PARAM = -3
    ERR_NO_MEMORY = -4
    ERR_NO_RESOURCE = -5
    ERR_NO_MESSAGE = -6
    ERR_NOT_FOUND = -7
    ERR_TIMED_OUT = -8
    ERR_CANCELED = -9
    ERR_RANK_FAILED = -10
    ERR_DATA_CORRUPTED = -11
    ERR_LAST = -100

    @property
    def is_error(self) -> bool:
        return self.value < 0

    def __str__(self) -> str:  # matches ucc_status_string flavor
        return _STATUS_STR.get(self, f"unknown status {self.value}")


_STATUS_STR = {
    Status.OK: "Success",
    Status.IN_PROGRESS: "Operation in progress",
    Status.OPERATION_INITIALIZED: "Operation initialized",
    Status.ERR_NOT_SUPPORTED: "Operation is not supported",
    Status.ERR_NOT_IMPLEMENTED: "Operation is not implemented",
    Status.ERR_INVALID_PARAM: "Invalid parameter",
    Status.ERR_NO_MEMORY: "Out of memory",
    Status.ERR_NO_RESOURCE: "Resource is not available",
    Status.ERR_NO_MESSAGE: "No message available",
    Status.ERR_NOT_FOUND: "Not found",
    Status.ERR_TIMED_OUT: "Operation timed out",
    Status.ERR_CANCELED: "Operation canceled",
    Status.ERR_RANK_FAILED: "A team member rank has failed",
    Status.ERR_DATA_CORRUPTED: "Data integrity check failed",
}


class UccError(Exception):
    """Raised by the raising flavor of the API when a call fails."""

    def __init__(self, status: Status, msg: str = ""):
        self.status = Status(status)
        super().__init__(f"{self.status.name}: {msg}" if msg else self.status.name)


class RankFailedError(UccError):
    """ERR_RANK_FAILED carrying the failed-rank set (context ranks unless
    the raiser documents otherwise), as ULFM's UCC_ERR_PROC_FAILED. The
    caller recovers by agreeing on the failed set and shrinking the team
    (``Team.shrink``)."""

    def __init__(self, msg: str = "", ranks=()):
        self.ranks = frozenset(int(r) for r in ranks)
        detail = msg or "rank failure"
        if self.ranks:
            detail = f"{detail} (ranks {sorted(self.ranks)})"
        super().__init__(Status.ERR_RANK_FAILED, detail)


class DataCorruptedError(UccError):
    """ERR_DATA_CORRUPTED carrying attribution: *ranks* are the ctx ranks
    whose data failed a checksum (a wire crc mismatch names the sender; a
    digest-attestation minority names the corruptor), and *quarantine*
    the subset whose strike budget is exhausted. The caller recovers by
    excluding those like dead ranks (``Team.shrink``; they may rejoin
    later through ``Team.join``)."""

    def __init__(self, msg: str = "", ranks=(), quarantine=()):
        self.ranks = frozenset(int(r) for r in ranks)
        self.quarantine = frozenset(int(r) for r in quarantine)
        detail = msg or "data corruption detected"
        if self.ranks:
            detail = f"{detail} (ctx ranks {sorted(self.ranks)})"
        super().__init__(Status.ERR_DATA_CORRUPTED, detail)


def check(status, msg: str = ""):
    """Raise UccError if *status* is an error; return it otherwise.
    Accepts raw ints too (negative = error)."""
    if isinstance(status, int) and int(status) < 0:
        try:
            status = Status(status)
        except ValueError:
            status = Status.ERR_LAST
        raise UccError(status, msg)
    return status
