"""Block helpers of the v-collectives and of the near-equal split (UCC's
ucc_math.h and the block helpers of ucc_coll_utils.h)."""
from __future__ import annotations

from typing import List, Sequence


def block_count(total: int, n_blocks: int, block: int) -> int:
    """Size of *block* when `total` is split into `n_blocks` near-equal
    parts (ucc_buffer_block_count): the first `total % n` blocks get one
    element more."""
    base = total // n_blocks
    rem = total % n_blocks
    return base + (1 if block < rem else 0)


def block_offset(total: int, n_blocks: int, block: int) -> int:
    """Offset of *block* in the near-equal split (ucc_buffer_block_offset)."""
    base = total // n_blocks
    rem = total % n_blocks
    return block * base + min(block, rem)


def default_displs(counts: Sequence[int]) -> List[int]:
    """Dense displacements of a v-collective's counts vector (the MPI
    convention: block k starts where block k-1 ended)."""
    out = [0] * len(counts)
    acc = 0
    for i, c in enumerate(counts):
        out[i] = acc
        acc += int(c)
    return out
