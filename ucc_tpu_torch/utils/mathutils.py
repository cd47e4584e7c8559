"""Integer and block helpers (UCC's ucc_math.h and the block helpers of
ucc_coll_utils.h)."""
from __future__ import annotations

from typing import List, Sequence


def ilog2(n: int) -> int:
    if n <= 0:
        raise ValueError("ilog2 of non-positive value")
    return n.bit_length() - 1


def is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def next_pow2(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def gcd(a: int, b: int) -> int:
    while b:
        a, b = b, a % b
    return a


def lcm(a: int, b: int) -> int:
    return a // gcd(a, b) * b


def div_round_up(a: int, b: int) -> int:
    return (a + b - 1) // b


def align_up(x: int, a: int) -> int:
    return div_round_up(x, a) * a


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


def block_offset_aligned(total: int, n_blocks: int, block: int,
                         align: int) -> int:
    """``block_offset`` rounded up to a multiple of `align`, at most
    `total` (ring reduce-scatter fragmenting)."""
    off = block_offset(total, n_blocks, block)
    off = (off + align - 1) // align * align
    return min(off, total)


def block_count_aligned(total: int, n_blocks: int, block: int,
                        align: int) -> int:
    """Size of *block* between two aligned offsets."""
    off = block_offset_aligned(total, n_blocks, block, align)
    nxt = block_offset_aligned(total, n_blocks, block + 1, align) \
        if block + 1 < n_blocks else total
    return nxt - off


def default_displs(counts: Sequence[int]) -> List[int]:
    """Dense displacements of a v-collective's counts vector (the MPI
    convention: block k starts where block k-1 ended)."""
    out = [0] * len(counts)
    acc = 0
    for i, c in enumerate(counts):
        out[i] = acc
        acc += int(c)
    return out
