"""Component-scoped logging (the port's copy of ``ucc_tpu.utils.log``).

UCS-style logger behavior: per-component log levels (``UCC_LOG_LEVEL``,
``UCC_TL_RING_CUDA_LOG_LEVEL``, ...), optional log file (``UCC_LOG_FILE``),
and the same level names. Built on stdlib logging so it composes with host
applications; loggers live under ``ucc_tpu_torch.*``.
"""
from __future__ import annotations

import logging
import os
import sys
from typing import Dict

LEVELS = {
    "fatal": logging.CRITICAL,
    "error": logging.ERROR,
    "warn": logging.WARNING,
    "diag": logging.WARNING,   # UCS 'diag' sits between warn and info
    "info": logging.INFO,
    "debug": logging.DEBUG,
    "trace": logging.DEBUG - 1,
    "trace_req": logging.DEBUG - 2,
    "trace_data": logging.DEBUG - 3,
    "trace_func": logging.DEBUG - 4,
    "trace_poll": logging.DEBUG - 5,
}

TRACE = logging.DEBUG - 1

_handler_installed = False
_loggers: Dict[str, logging.Logger] = {}


def _install_handler(root: logging.Logger) -> None:
    global _handler_installed
    if _handler_installed:
        return
    log_file = os.environ.get("UCC_LOG_FILE", "")
    if log_file:
        handler: logging.Handler = logging.FileHandler(log_file)
    else:
        handler = logging.StreamHandler(sys.stderr)
    fmt = logging.Formatter(
        "[%(asctime)s] [%(process)d] %(name)s %(levelname)-5s %(message)s",
        datefmt="%H:%M:%S")
    handler.setFormatter(fmt)
    root.addHandler(handler)
    root.propagate = False
    _handler_installed = True


def parse_level(s: str) -> int:
    v = s.strip().lower()
    if v not in LEVELS:
        raise ValueError(f"invalid log level '{s}' (expected one of {list(LEVELS)})")
    return LEVELS[v]


def get_logger(component: str = "ucc") -> logging.Logger:
    """Logger for a component, honoring UCC_<COMP>_LOG_LEVEL then UCC_LOG_LEVEL."""
    if component in _loggers:
        return _loggers[component]
    root = logging.getLogger("ucc_tpu_torch")
    _install_handler(root)
    name = "ucc_tpu_torch" if component in ("", "ucc") \
        else f"ucc_tpu_torch.{component}"
    logger = logging.getLogger(name)
    comp_env = f"UCC_{component.upper()}_LOG_LEVEL" if component not in ("", "ucc") \
        else "UCC_LOG_LEVEL"
    level_s = os.environ.get(comp_env) or os.environ.get("UCC_LOG_LEVEL", "warn")
    try:
        logger.setLevel(parse_level(level_s))
    except ValueError:
        logger.setLevel(logging.WARNING)
    _loggers[component] = logger
    return logger


log = get_logger("ucc")
