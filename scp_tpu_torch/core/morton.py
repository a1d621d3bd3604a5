"""Copy of scp_tpu/core/morton.py (the port imports nothing of the
JAX package).

Morton (Z-order) codes for integer point grids.

Bit convention (matches the octree serialization of the reference codec,
`data_preproc/Octree.py:56-65`): the interleaved key reads, from the most
significant digit down, one base-8 octant digit per tree level, where each
digit packs (x_bit << 2) | (y_bit << 1) | z_bit.  Sorting points by this key
yields breadth-first octree order at every level simultaneously.

All functions are vectorized numpy on uint64; supports up to 21 bits/axis.
"""

from __future__ import annotations

import numpy as np

_MAX_BITS = 21  # 3*21 = 63 bits, fits uint64


def axis_bits(points: np.ndarray) -> int:
    """Bits per axis needed to represent non-negative integer `points`.

    Matches the reference's level count: ceil(log2(max+1)) over the global
    max (`Octree.py:58`), i.e. values up to 2^b - 1 use b bits.
    """
    if int(points.min()) < 0:
        raise ValueError("points must be non-negative")
    return max(int(points.max()).bit_length(), 1)


def _part1by2(v: np.ndarray) -> np.ndarray:
    """Spread the low 21 bits of v so bit i lands at position 3*i."""
    v = v.astype(np.uint64) & np.uint64(0x1FFFFF)
    v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
    return v


def _compact1by2(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint64) & np.uint64(0x1249249249249249)
    v = (v | (v >> np.uint64(2))) & np.uint64(0x10C30C30C30C30C3)
    v = (v | (v >> np.uint64(4))) & np.uint64(0x100F00F00F00F00F)
    v = (v | (v >> np.uint64(8))) & np.uint64(0x1F0000FF0000FF)
    v = (v | (v >> np.uint64(16))) & np.uint64(0x1F00000000FFFF)
    v = (v | (v >> np.uint64(32))) & np.uint64(0x1FFFFF)
    return v


def morton_encode(points: np.ndarray, bits: int | None = None) -> np.ndarray:
    """Interleave (N, 3) non-negative int points into uint64 Morton keys.

    x is the most significant axis within each octant digit.
    """
    if bits is None:
        bits = axis_bits(points)
    if bits > _MAX_BITS:
        raise ValueError(f"bits={bits} exceeds max {_MAX_BITS}")
    p = points.astype(np.uint64)
    return (
        (_part1by2(p[:, 0]) << np.uint64(2))
        | (_part1by2(p[:, 1]) << np.uint64(1))
        | _part1by2(p[:, 2])
    )


def morton_decode(keys: np.ndarray, bits: int) -> np.ndarray:
    """Inverse of morton_encode: uint64 keys -> (N, 3) int64 points."""
    keys = keys.astype(np.uint64)
    x = _compact1by2(keys >> np.uint64(2))
    y = _compact1by2(keys >> np.uint64(1))
    z = _compact1by2(keys)
    out = np.stack([x, y, z], axis=1).astype(np.int64)
    mask = (np.int64(1) << np.int64(bits)) - np.int64(1)
    return out & mask
