"""Host-side helpers for building the LUTs.

Counterpart of ``blocksparse_tpu/utils.py`` (the part the ported paths
need).  Pure Python: nothing here touches a tensor.
"""
from __future__ import annotations

from functools import reduce
from operator import mul


def ceil_div(x: int, y: int) -> int:
    return -(-x // y)


def reduce_mul(vals, init=1):
    return reduce(mul, vals, init)


def z_order_2d(x: int, y: int) -> int:
    """Morton interleave of 2-D coords: the block-id order of
    ``BlocksparseMatMul`` (weight-storage locality)."""
    answer = 0
    bits = max(len(bin(x)), len(bin(y))) - 2
    for i in range(bits):
        mshifted = 1 << i
        answer |= ((x & mshifted) << i) | ((y & mshifted) << (i + 1))
    return answer
