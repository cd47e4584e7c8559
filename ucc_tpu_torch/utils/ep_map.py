"""Endpoint maps (the port's copy of ``ucc_tpu.utils.ep_map``).

UCC's rank-translation machinery (``ucc_ep_map_eval`` and the team ep_map
kinds): EpMap kinds FULL / STRIDED / ARRAY / CB / REVERSED,
``eval(local_rank) -> context rank``, inverse lookup, composition.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np


class EpMapType(enum.IntEnum):
    FULL = 0       # identity: local i -> i
    STRIDED = 1    # i -> start + i*stride
    ARRAY = 2      # i -> array[i]
    CB = 3         # i -> cb(i)
    REVERSED = 4   # i -> n-1-i


@dataclass
class EpMap:
    """Maps [0, ep_num) onto endpoints in a parent space."""

    type: EpMapType
    ep_num: int
    start: int = 0
    stride: int = 1
    array: Optional[np.ndarray] = None
    cb: Optional[Callable[[int], int]] = None

    # -- constructors ------------------------------------------------------
    @classmethod
    def full(cls, n: int) -> "EpMap":
        return cls(EpMapType.FULL, n)

    @classmethod
    def strided(cls, start: int, stride: int, n: int) -> "EpMap":
        return cls(EpMapType.STRIDED, n, start=start, stride=stride)

    @classmethod
    def from_array(cls, arr: Sequence[int], need_free: bool = False) -> "EpMap":
        a = np.asarray(arr, dtype=np.int64)
        # ARRAY maps that are really full/strided collapse to those kinds
        # (as ucc_ep_map_from_array does)
        n = len(a)
        if n > 0:
            if np.array_equal(a, np.arange(n)):
                return cls.full(n)
            if n > 1:
                stride = int(a[1] - a[0])
                if stride != 0 and np.array_equal(a, a[0] + stride * np.arange(n)):
                    return cls.strided(int(a[0]), stride, n)
        return cls(EpMapType.ARRAY, n, array=a)

    @classmethod
    def from_cb(cls, cb: Callable[[int], int], n: int) -> "EpMap":
        return cls(EpMapType.CB, n, cb=cb)

    @classmethod
    def reversed(cls, n: int) -> "EpMap":
        return cls(EpMapType.REVERSED, n)

    # -- ops ---------------------------------------------------------------
    def eval(self, rank: int) -> int:
        """ucc_ep_map_eval."""
        if not (0 <= rank < self.ep_num):
            raise IndexError(f"rank {rank} out of ep_map range {self.ep_num}")
        t = self.type
        if t == EpMapType.FULL:
            return rank
        if t == EpMapType.STRIDED:
            return self.start + rank * self.stride
        if t == EpMapType.ARRAY:
            return int(self.array[rank])
        if t == EpMapType.CB:
            return int(self.cb(rank))
        if t == EpMapType.REVERSED:
            return self.ep_num - 1 - rank
        raise ValueError(f"bad ep_map type {t}")

    def local_rank(self, ep: int) -> int:
        """Inverse eval (ucc_ep_map_local_rank analog); raises if absent."""
        t = self.type
        if t == EpMapType.FULL:
            if 0 <= ep < self.ep_num:
                return ep
        elif t == EpMapType.STRIDED:
            off = ep - self.start
            if off % self.stride == 0:
                i = off // self.stride
                if 0 <= i < self.ep_num:
                    return int(i)
        elif t == EpMapType.REVERSED:
            i = self.ep_num - 1 - ep
            if 0 <= i < self.ep_num:
                return i
        else:
            for i in range(self.ep_num):
                if self.eval(i) == ep:
                    return i
        raise KeyError(f"endpoint {ep} not in ep_map")

    def contains(self, ep: int) -> bool:
        try:
            self.local_rank(ep)
            return True
        except KeyError:
            return False

    def to_array(self) -> np.ndarray:
        return np.asarray([self.eval(i) for i in range(self.ep_num)], dtype=np.int64)

    def compose(self, inner: "EpMap") -> "EpMap":
        """self ∘ inner: local rank of *inner* -> endpoint of *self*'s parent.

        Used when a subgroup (inner) sits inside a team whose ctx map is
        *self*.
        """
        if inner.type == EpMapType.FULL and inner.ep_num == self.ep_num:
            return self
        return EpMap.from_array([self.eval(inner.eval(i))
                                 for i in range(inner.ep_num)])

    def __len__(self) -> int:
        return self.ep_num

    def __eq__(self, other) -> bool:
        if not isinstance(other, EpMap):
            return NotImplemented
        if self.ep_num != other.ep_num:
            return False
        return all(self.eval(i) == other.eval(i) for i in range(self.ep_num))


@dataclass
class Subset:
    """ucc_subset_t: an ep_map plus my local rank in it (the group ranks a
    host algorithm speaks: a team, an active set)."""

    map: EpMap
    myrank: int

    @property
    def size(self) -> int:
        return self.map.ep_num

    def rank_to_parent(self, r: int) -> int:
        return self.map.eval(r)


def active_set_map(start: int, stride: int, size: int) -> EpMap:
    """Active-set subset: start/stride/size over team ranks."""
    return EpMap.strided(start, stride, size)
