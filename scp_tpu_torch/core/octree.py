"""Vectorized breadth-first octree build / unbuild and K-ancestor contexts.

Copy of scp_tpu/core/octree.py; above NATIVE_MIN_KEYS leaves the build
takes the port's own C++ builder (scp_tpu_torch/native), as scp_tpu does.

Semantics follow the reference codec's octree serialization
(the reference codec's `data_preproc/Octree.py`: `GenOctree` :148-181, `DeOctree`
:68-99, `gen_K_parent_seq` :102-137) but the implementation is a sort-based
array program — no per-node Python objects or loops — so building a 1M-point
tree is a handful of numpy kernel calls.

Definitions (1-based levels, matching the reference):
  * A *node at level L* is an occupied cell at tree depth L-1; the root cell
    is the single level-1 node.  A node's occupancy byte has bit o set
    (value 2^o) iff its child octant o = (x<<2)|(y<<1)|z is occupied.
  * Breadth-first order = levels ascending, nodes within a level ascending by
    Morton prefix (identical to the reference's creation order).
  * `octant` of a node = 1 + its own octant digit within its parent
    (the level-1 root stores octant 1).
  * `pos` of a node at level L = its own cell origin on the full-resolution
    grid: sum over its first L-1 Morton digits d_j of d_j * 2^(Lmax-j).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from scp_tpu_torch.core.morton import axis_bits, morton_decode, morton_encode

NATIVE_MIN_KEYS = 2048  # the native builder takes clouds of more leaves than this


@dataclasses.dataclass
class OctreeArrays:
    """Flat BFS arrays for one octree. Node index is 0-based over N nodes."""

    occupancy: np.ndarray  # (N,) int32 in 1..255, the serialized byte stream
    level: np.ndarray  # (N,) int32, 1-based
    octant: np.ndarray  # (N,) int32 in 1..8
    parent: np.ndarray  # (N,) int64, BFS index of parent; root's parent = -1
    pos: np.ndarray  # (N, 3) int64 cell origin at full resolution
    level_starts: np.ndarray  # (Lmax+1,) int64; nodes of level l occupy
    # [level_starts[l-1], level_starts[l])
    max_level: int  # Lmax: leaf voxels live at depth Lmax

    @property
    def num_nodes(self) -> int:
        return int(self.occupancy.shape[0])

    def nodes_at_level(self, l: int) -> slice:
        return slice(int(self.level_starts[l - 1]), int(self.level_starts[l]))


def build_octree(points: np.ndarray, max_level: int | None = None,
                 native: bool = True) -> OctreeArrays:
    """Build the BFS octree of unique non-negative integer points.

    `max_level` overrides the derived bit depth (reference `GenOctree`'s
    Lmax argument); by default it is the minimal bit count of the data.
    `native=False` keeps the numpy builder at every size.
    """
    points = np.asarray(points)
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError("points must be (N, 3)")
    if points.shape[0] == 0:
        raise ValueError("cannot build an octree from an empty point set")
    bits = axis_bits(points) if max_level is None else int(max_level)
    keys = morton_encode(points, bits)
    keys = np.unique(keys)  # sorted unique leaf keys
    return _build_from_keys(keys, bits, native)


def _build_from_keys(keys: np.ndarray, bits: int, native: bool = True) -> OctreeArrays:
    """Build from sorted unique full-depth Morton keys: the native C++
    builder above NATIVE_MIN_KEYS keys (built at first use; a failed build
    raises), the numpy one otherwise."""
    if native and keys.shape[0] > NATIVE_MIN_KEYS:
        from scp_tpu_torch.native import octree_native

        return octree_native.build_from_keys(keys, bits)
    return _build_from_keys_numpy(keys, bits)


def _build_from_keys_numpy(keys: np.ndarray, bits: int) -> OctreeArrays:
    n_pts = keys.shape[0]
    occ_l, oct_l, par_l, pos_l = [], [], [], []
    level_sizes = []

    # prefixes[l] = sorted unique Morton prefixes of length l (cells at depth l)
    prev_prefix = np.zeros(1, dtype=np.uint64)  # depth-0 root cell
    prev_start = 0
    total = 0
    for depth in range(bits):  # node level = depth + 1
        shift = np.uint64(3 * (bits - depth - 1))
        child_prefix = keys >> shift
        # Occupied child cells at depth+1, in sorted order:
        uniq_child = np.unique(child_prefix)
        # Occupancy byte of each depth-`depth` node: OR of child digit bits,
        # grouped by the node's prefix.  Each unique child contributes one bit
        # to its parent (uniq_child >> 3); children of one parent are
        # contiguous because uniq_child is sorted.
        parents_of_children = uniq_child >> np.uint64(3)
        bitvals = np.left_shift(
            np.int64(1), (uniq_child & np.uint64(7)).astype(np.int64)
        )
        group_starts = np.searchsorted(parents_of_children, prev_prefix, side="left")
        occ = np.bitwise_or.reduceat(bitvals, group_starts)

        occ_l.append(occ.astype(np.int32))
        if depth == 0:
            oct_l.append(np.ones(1, dtype=np.int32))
            par_l.append(np.full(1, -1, dtype=np.int64))
        else:
            oct_l.append((prev_prefix & np.uint64(7)).astype(np.int32) + 1)
            # Parent BFS index: position of (prefix >> 3) in the previous
            # level's prefix list, offset by that level's BFS start.
            grandparents = np.searchsorted(prev_prev_prefix, prev_prefix >> np.uint64(3))
            par_l.append(grandparents + prev_prev_start)
        pos_l.append(morton_decode(prev_prefix, bits) << np.int64(bits - depth))

        level_sizes.append(prev_prefix.shape[0])
        total += prev_prefix.shape[0]
        prev_prev_prefix, prev_prev_start = prev_prefix, prev_start
        prev_start = total
        prev_prefix = uniq_child

    level_starts = np.zeros(bits + 1, dtype=np.int64)
    np.cumsum(level_sizes, out=level_starts[1:])
    return OctreeArrays(
        occupancy=np.concatenate(occ_l),
        level=np.repeat(
            np.arange(1, bits + 1, dtype=np.int32),
            np.asarray(level_sizes, dtype=np.int64),
        ),
        octant=np.concatenate(oct_l),
        parent=np.concatenate(par_l),
        pos=np.concatenate(pos_l),
        level_starts=level_starts,
        max_level=bits,
    )


def gen_context(tree: OctreeArrays, k: int = 4) -> np.ndarray:
    """Per-node K-ancestor context array of shape (N, K, 6).

    Channel layout matches the reference's training shard format
    (`data_preprocess.py:74`): channel 0 occupancy (1..255; 256 = missing
    ancestor), 1 level (0 = missing), 2 octant (1..8; 0 = missing),
    3:6 cell position (0 = missing).  Row K-1 is the node itself, rows
    K-2..0 its parent chain.
    """
    n = tree.num_nodes
    # Sentinel row 0; node i lives at row i+1.
    occ = np.concatenate([[256], tree.occupancy]).astype(np.int64)
    lev = np.concatenate([[0], tree.level]).astype(np.int64)
    octant = np.concatenate([[0], tree.octant]).astype(np.int64)
    pos = np.concatenate([np.zeros((1, 3), np.int64), tree.pos])
    parent1 = np.concatenate([[0], tree.parent + 1])  # root -> sentinel 0

    out = np.zeros((n, k, 6), dtype=np.int64)
    idx = np.arange(1, n + 1)
    for row in range(k - 1, -1, -1):
        out[:, row, 0] = occ[idx]
        out[:, row, 1] = lev[idx]
        out[:, row, 2] = octant[idx]
        out[:, row, 3:6] = pos[idx]
        idx = parent1[idx]
    # Missing-ancestor rows: occupancy sentinel is 256 and the rest 0,
    # already guaranteed by sentinel row 0 above.
    return out


def occupancy_to_child_octants(occ: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Expand occupancy bytes into child (parent_index, octant) pairs.

    Children are emitted in BFS order: parents ascending, octants ascending.
    Returns (parent_idx (M,), octant (M,) in 0..7).
    """
    occ = np.asarray(occ, dtype=np.int64)
    bits = (occ[:, None] >> np.arange(8)) & 1  # (N, 8), col = octant
    parent_idx, octant = np.nonzero(bits)
    return parent_idx, octant


def deoctree(codes: np.ndarray) -> np.ndarray:
    """Rebuild leaf grid coordinates from the BFS occupancy byte stream.

    Inverse of serialization (reference `DeOctree`, `Octree.py:68-99`):
    consumes level by level; the number of levels is implied by the stream.
    Returns (P, 3) int64 leaf coordinates in BFS (= sorted Morton) order.
    """
    codes = np.asarray(codes, dtype=np.int64).reshape(-1)
    code_len = codes.shape[0]
    # Determine level sizes: level 1 has 1 node; level l+1 has
    # popcount(sum of level-l bytes) nodes.
    sizes = [1]
    consumed = 0
    popcnt = np.zeros(256, dtype=np.int64)
    for v in range(256):
        popcnt[v] = bin(v).count("1")
    while consumed + sizes[-1] <= code_len:
        lvl = codes[consumed : consumed + sizes[-1]]
        consumed += sizes[-1]
        sizes.append(int(popcnt[lvl].sum()))
    max_level = len(sizes) - 1

    keys = np.zeros(1, dtype=np.uint64)
    consumed = 0
    for l in range(1, max_level + 1):
        lvl = codes[consumed : consumed + sizes[l - 1]]
        consumed += sizes[l - 1]
        pidx, octant = occupancy_to_child_octants(lvl)
        keys = (keys[pidx] << np.uint64(3)) | octant.astype(np.uint64)
    return morton_decode(keys, max_level)


def morton_prefix_filter(points: np.ndarray, morton_path: list[int]) -> np.ndarray:
    """Indices of points whose x-axis Morton bit prefix equals `morton_path`.

    The multi-level octree splits the cloud by the first bits of the FIRST
    interleaved axis only (the radial axis in spherical/cylindrical grids) —
    reference `mullevel_gen_octree`, `Octree.py:188-190`, which masks
    `mcode[:, 0::3]` (x bits).
    """
    points = np.asarray(points)
    bits = axis_bits(points)
    x = points[:, 0].astype(np.int64)
    sel = np.ones(points.shape[0], dtype=bool)
    for j, want in enumerate(morton_path):
        bit = (x >> np.int64(bits - 1 - j)) & 1
        sel &= bit == int(want)
    return np.nonzero(sel)[0]
