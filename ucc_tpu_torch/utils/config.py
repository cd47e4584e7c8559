"""Typed configuration system (the port's own copy of
``ucc_tpu.utils.config``; UCC's UCS-backed config parser in Python):

  - typed fields (string/int/uint/bool/double/memunits/enum/allow-list/
    per-msgrange uints) with defaults and docstrings
  - environment variables with the ``UCC_`` prefix plus per-component
    prefixes (``UCC_TL_RING_CUDA_DEVICE=...``)
  - optional ini-style config file (``UCC_CONFIG_FILE`` / ucc.conf) —
    env always wins over file
  - programmatic modify (``ucc_*_config_modify`` analog)
  - a global table registry so introspection can dump every var

Memunits accept ``8``, ``4k``, ``128M``, ``2G``, ``inf``, ``auto`` like ucs.
"""
from __future__ import annotations

import configparser
import os
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# sentinels
# ---------------------------------------------------------------------------

SIZE_INF = (1 << 64) - 1   # matches UCC_MSG_MAX-style "inf" upper bound
SIZE_AUTO = (1 << 64) - 2
UINT_MAX = (1 << 32) - 1


# ---------------------------------------------------------------------------
# field parsers
# ---------------------------------------------------------------------------

def parse_bool(s: str) -> bool:
    v = s.strip().lower()
    if v in ("y", "yes", "on", "1", "true", "t"):
        return True
    if v in ("n", "no", "off", "0", "false", "f"):
        return False
    raise ValueError(f"invalid bool '{s}'")


def parse_int(s: str) -> int:
    return int(s.strip(), 0)


def parse_uint(s: str) -> int:
    v = s.strip().lower()
    if v in ("inf", "infinity", "unlimited"):
        return UINT_MAX
    if v == "auto":
        return SIZE_AUTO
    n = int(v, 0)
    if n < 0:
        raise ValueError(f"negative value '{s}' for unsigned field")
    return n


def parse_uint_auto(s: str) -> int:
    """Unsigned int or 'auto' -> SIZE_AUTO (the per-use-site default)."""
    if s.strip().lower() == "auto":
        return SIZE_AUTO
    return parse_uint(s)


def parse_double(s: str) -> float:
    return float(s.strip())


def parse_string(s: str) -> str:
    return s.strip()


_MEMUNIT_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*([kmgtp]?)b?\s*$", re.IGNORECASE)
_MEMUNIT_MUL = {"": 1, "k": 1 << 10, "m": 1 << 20, "g": 1 << 30,
                "t": 1 << 40, "p": 1 << 50}


def parse_memunits(s: str) -> int:
    """'4k' -> 4096, 'inf' -> SIZE_INF, 'auto' -> SIZE_AUTO."""
    v = s.strip().lower()
    if v in ("inf", "infinity", "unlimited"):
        return SIZE_INF
    if v == "auto":
        return SIZE_AUTO
    m = _MEMUNIT_RE.match(v)
    if not m:
        raise ValueError(f"invalid memunits value '{s}'")
    return int(float(m.group(1)) * _MEMUNIT_MUL[m.group(2).lower()])


def memunits_str(n: int) -> str:
    if n == SIZE_INF:
        return "inf"
    if n == SIZE_AUTO:
        return "auto"
    for suf, mul in (("P", 1 << 50), ("T", 1 << 40), ("G", 1 << 30),
                     ("M", 1 << 20), ("K", 1 << 10)):
        if n >= mul and n % mul == 0:
            return f"{n // mul}{suf}"
    return str(n)


@dataclass
class MRangeUint:
    """Per-message-size-range unsigned knob (ucc_mrange_uint_t): the syntax
    ``0-4k:4,4k-inf:8``, with an optional memory-type qualifier
    ``host:0-4k:4``; ``auto`` picks the algorithm's default."""

    ranges: List[Tuple[int, int, Optional[str], int]] = field(
        default_factory=list)
    # each entry: (start, end, memtype-or-None, value)
    default: int = SIZE_AUTO

    def get(self, msgsize: int, mem_type: Optional[str] = None) -> int:
        for start, end, mt, val in self.ranges:
            if start <= msgsize <= end and (mt is None or mt == mem_type):
                return val
        return self.default


def parse_mrange_uint(s: str) -> MRangeUint:
    out = MRangeUint()
    s = s.strip()
    if not s:
        return out
    for tok in s.split(","):
        parts = tok.strip().split(":")
        if len(parts) == 1:
            out.default = SIZE_AUTO if parts[0].lower() == "auto" \
                else parse_uint(parts[0])
            continue
        mt = None
        if len(parts) == 3:
            mt, rng, val = parts
            mt = mt.strip().lower()
        elif len(parts) == 2:
            rng, val = parts
        else:
            raise ValueError(f"invalid mrange token '{tok}'")
        if "-" not in rng:
            raise ValueError(f"invalid range '{rng}' in '{tok}'")
        lo, hi = rng.split("-", 1)
        start = parse_memunits(lo)
        end = parse_memunits(hi)
        v = SIZE_AUTO if val.strip().lower() == "auto" else parse_uint(val)
        out.ranges.append((start, end, mt, v))
    return out


def parse_list(s: str) -> List[str]:
    """Comma-separated allow-list; empty string -> []."""
    s = s.strip()
    if not s:
        return []
    return [tok.strip() for tok in s.split(",") if tok.strip()]


def parse_enum(values: Tuple[str, ...]) -> Callable[[str], str]:
    def _parse(s: str) -> str:
        v = s.strip().lower()
        if v not in values:
            raise ValueError(f"invalid value '{s}', expected one of {values}")
        return v
    return _parse


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------

@dataclass
class ConfigField:
    name: str                       # e.g. "ALLREDUCE_KN_RADIX"
    default: str                    # default as a string, parsed like env input
    doc: str = ""
    parser: Callable[[str], Any] = parse_string


@dataclass
class ConfigTable:
    """A component's config table (UCC_CONFIG_REGISTER_TABLE analog)."""

    prefix: str                     # e.g. "TL_RING_CUDA_" ('' for globals)
    fields: List[ConfigField]
    name: str = ""                  # component name for dumps

    def field_env_name(self, f: ConfigField) -> str:
        return f"UCC_{self.prefix}{f.name}"


#: global registry: component name -> ConfigTable (for config dumps)
_REGISTRY: Dict[str, ConfigTable] = {}


def register_table(table: ConfigTable) -> ConfigTable:
    _REGISTRY[table.name or table.prefix] = table
    return table


def registered_tables() -> Dict[str, ConfigTable]:
    return dict(_REGISTRY)


# ---------------------------------------------------------------------------
# file config
# ---------------------------------------------------------------------------

_file_cfg_cache: Dict[str, Dict[str, str]] = {}


def load_config_file(path: str) -> Dict[str, str]:
    """Parse an ini-ish ucc.conf: ``UCC_FOO=bar`` lines, sections
    optional."""
    if path in _file_cfg_cache:
        return _file_cfg_cache[path]
    out: Dict[str, str] = {}
    if os.path.isfile(path):
        cp = configparser.ConfigParser(delimiters=("=",), strict=False,
                                       interpolation=None)
        cp.optionxform = str  # keep case
        try:
            with open(path) as fh:
                content = fh.read()
            if not re.search(r"^\s*\[", content, re.M):
                content = "[global]\n" + content
            cp.read_string(content)
            for section in cp.sections():
                for k, v in cp.items(section):
                    out[k.strip()] = v.strip()
        except configparser.Error:
            pass
    _file_cfg_cache[path] = out
    return out


# ---------------------------------------------------------------------------
# Config object
# ---------------------------------------------------------------------------

class Config:
    """Parsed configuration for one component.

    Attribute access by lower-cased field name:
    ``cfg.device``. ``modify()`` mirrors ucc_*_config_modify.
    """

    def __init__(self, table: ConfigTable, env: Optional[Dict[str, str]] = None,
                 overrides: Optional[Dict[str, str]] = None):
        self._table = table
        self._values: Dict[str, Any] = {}
        self._raw: Dict[str, str] = {}
        env = os.environ if env is None else env
        file_vals: Dict[str, str] = {}
        cfg_file = env.get("UCC_CONFIG_FILE", "")
        if cfg_file:
            file_vals = load_config_file(cfg_file)
        for f in table.fields:
            env_name = table.field_env_name(f)
            raw = f.default
            if env_name in file_vals:
                raw = file_vals[env_name]
            if env_name in env:          # env wins over file
                raw = env[env_name]
            if overrides and f.name in overrides:
                raw = overrides[f.name]
            try:
                val = f.parser(raw)
            except (ValueError, TypeError) as e:
                raise ValueError(f"failed to parse {env_name}='{raw}': {e}") from e
            self._values[f.name] = val
            self._raw[f.name] = raw

    def __getattr__(self, key: str) -> Any:
        values = object.__getattribute__(self, "_values")
        upper = key.upper()
        if upper in values:
            return values[upper]
        raise AttributeError(key)

    def get(self, name: str) -> Any:
        return self._values[name.upper()]

    def modify(self, name: str, value: str) -> None:
        """ucc_config_modify analog: re-parse *value* for field *name*."""
        upper = name.upper()
        for f in self._table.fields:
            if f.name == upper:
                self._values[upper] = f.parser(value)
                self._raw[upper] = value
                return
        raise KeyError(f"no config field '{name}' in table "
                       f"'{self._table.name or self._table.prefix}'")

    def dump(self) -> List[Tuple[str, str, str]]:
        """[(env_name, current_raw_value, doc)] for introspection."""
        out = []
        for f in self._table.fields:
            out.append((self._table.field_env_name(f), self._raw[f.name], f.doc))
        return out
