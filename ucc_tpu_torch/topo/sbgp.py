"""Subgroups (sbgp): rank subsets derived from the topology (UCC's
``ucc_sbgp``: its subgroup types and the states NOT_EXISTS, ENABLED and
DISABLED).

cl/hier builds its hierarchy from these: NODE (the ranks on my host),
NODE_LEADERS (one rank per host), NET (my local-rank peers across hosts,
the "rails"), FULL, and FULL_HOST_ORDERED (the ranks sorted so that hosts
are contiguous, which the host TLs' ring reorder uses).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

from ..utils.ep_map import EpMap, Subset


class SbgpType(enum.IntEnum):
    NUMA = 0
    SOCKET = 1
    NODE = 2
    NODE_LEADERS = 3
    NET = 4
    SOCKET_LEADERS = 5
    NUMA_LEADERS = 6
    FULL = 7
    FULL_HOST_ORDERED = 8
    LAST = 9


class SbgpStatus(enum.IntEnum):
    NOT_EXISTS = 0
    ENABLED = 1
    DISABLED = 2


@dataclass
class Sbgp:
    type: SbgpType
    status: SbgpStatus
    #: my rank within the subgroup (-1 if not a member)
    group_rank: int = -1
    #: subgroup rank -> team rank
    map: Optional[EpMap] = None

    @property
    def size(self) -> int:
        return self.map.ep_num if self.map is not None else 0

    @property
    def is_member(self) -> bool:
        return self.status == SbgpStatus.ENABLED and self.group_rank >= 0

    def subset(self) -> Subset:
        assert self.map is not None and self.group_rank >= 0
        return Subset(self.map, self.group_rank)
