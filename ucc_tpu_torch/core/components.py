"""Component framework: base interfaces + discovery.

UCC's component vtables (lib/context/team/coll, ``ucc_tl_iface_t``,
``ucc_cl_iface_t``). UCC discovers components by glob-dlopen of
``libucc_<fw>_*.so``; here discovery imports ``ucc_tpu_torch.tl.<name>`` /
``ucc_tpu_torch.cl.<name>`` modules on demand and components
self-register via the ``@register_tl`` / ``@register_cl`` decorators.
``UCC_TLS`` / ``UCC_CLS`` env allow-lists select what loads.
"""
from __future__ import annotations

import importlib
import pkgutil
import threading
from typing import Dict, List, Optional, Type

from ..constants import CollType, MemoryType
from ..score.score import CollScore
from ..status import Status, UccError
from ..utils.config import Config, ConfigTable
from ..utils.log import get_logger

logger = get_logger("core")


class BaseLib:
    """Per-(core lib × component) object (ucc_base_lib_iface_t)."""

    def __init__(self, core_lib, config: Config):
        self.core_lib = core_lib
        self.config = config


class BaseContext:
    """Per-(core context × component) object (ucc_base_context_iface_t)."""

    def __init__(self, comp_lib: BaseLib, core_context, config: Optional[Config]):
        self.comp_lib = comp_lib
        self.core_context = core_context
        self.config = config

    def pack_address(self) -> bytes:
        """Worker address contributed to the context OOB exchange."""
        return b""

    def unpack_addresses(self, addrs: Dict[int, bytes]) -> None:
        """Receive peers' packed addresses keyed by ctx rank."""

    def create_epilog(self) -> None:
        """Post-exchange hook (tl/ucp preconnect analog)."""

    def progress(self) -> None:
        """Registered into the context progress loop when overridden."""

    def destroy(self) -> None:
        pass


class BaseTeam:
    """Component team (ucc_base_team_iface_t). Creation is nonblocking:
    construct → poll create_test() until OK/error."""

    def __init__(self, comp_context: BaseContext, core_team):
        self.comp_context = comp_context
        self.core_team = core_team

    @property
    def name(self) -> str:
        return getattr(type(self), "NAME", "?")

    def create_test(self) -> Status:
        return Status.OK

    def get_scores(self) -> CollScore:
        raise NotImplementedError

    def destroy(self) -> None:
        pass


class TransportLayer:
    """TL component descriptor (ucc_tl_iface_t)."""

    NAME = "base"
    DEFAULT_SCORE = 10            # selection prior
    SUPPORTED_COLLS: CollType = CollType(0)
    SUPPORTED_MEM_TYPES = (MemoryType.HOST,)

    LIB_CONFIG: Optional[ConfigTable] = None
    CONTEXT_CONFIG: Optional[ConfigTable] = None

    lib_cls: Type[BaseLib] = BaseLib
    context_cls: Type[BaseContext] = BaseContext
    team_cls: Type[BaseTeam] = BaseTeam

    #: TLs that can serve as the core service team (UCC's service coll
    #: vtable). The core picks the first available in this order.
    SERVICE_CAPABLE = False


class CollectiveLayer:
    """CL component descriptor (ucc_cl_iface_t)."""

    NAME = "base"
    DEFAULT_SCORE = 50
    #: which TLs this CL wants (None = all loaded; per-CL TLS config can
    #: narrow further)
    REQUIRED_TLS: Optional[List[str]] = None

    LIB_CONFIG: Optional[ConfigTable] = None
    CONTEXT_CONFIG: Optional[ConfigTable] = None

    lib_cls: Type[BaseLib] = BaseLib
    context_cls: Type[BaseContext] = BaseContext
    team_cls: Type[BaseTeam] = BaseTeam


# ---------------------------------------------------------------------------
# registries + discovery
# ---------------------------------------------------------------------------

TL_REGISTRY: Dict[str, Type[TransportLayer]] = {}
CL_REGISTRY: Dict[str, Type[CollectiveLayer]] = {}


def register_tl(cls: Type[TransportLayer]) -> Type[TransportLayer]:
    TL_REGISTRY[cls.NAME] = cls
    return cls


def register_cl(cls: Type[CollectiveLayer]) -> Type[CollectiveLayer]:
    CL_REGISTRY[cls.NAME] = cls
    return cls


_discovered = False
_discover_lock = threading.Lock()


def discover_components() -> None:
    """Import every module under ucc_tpu_torch.tl / ucc_tpu_torch.cl (the
    dlopen-glob analog). Failures are logged and skipped, as UCC tolerates
    missing optional .so deps. Threads that call it at once (libs made in
    a thread per rank) all return after the imports are done."""
    global _discovered
    if _discovered:
        return
    with _discover_lock:
        if _discovered:
            return
        import ucc_tpu_torch.cl as cl_pkg
        import ucc_tpu_torch.tl as tl_pkg
        for pkg in (tl_pkg, cl_pkg):
            for info in pkgutil.iter_modules(pkg.__path__):
                if info.name.startswith("_") or info.name == "base":
                    continue
                modname = f"{pkg.__name__}.{info.name}"
                try:
                    importlib.import_module(modname)
                except Exception as e:  # noqa: BLE001 - optional component
                    logger.warning("failed to load component %s: %s",
                                   modname, e)
        _discovered = True


def get_tl(name: str) -> Type[TransportLayer]:
    discover_components()
    if name not in TL_REGISTRY:
        raise UccError(Status.ERR_NOT_FOUND, f"TL '{name}' not found")
    return TL_REGISTRY[name]


def get_cl(name: str) -> Type[CollectiveLayer]:
    discover_components()
    if name not in CL_REGISTRY:
        raise UccError(Status.ERR_NOT_FOUND, f"CL '{name}' not found")
    return CL_REGISTRY[name]


def available_tls() -> List[str]:
    discover_components()
    return sorted(TL_REGISTRY)


def available_cls() -> List[str]:
    discover_components()
    return sorted(CL_REGISTRY)
