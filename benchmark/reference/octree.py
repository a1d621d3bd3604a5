"""Plain NumPy reference of the sweep's preprocessing and of the contexts
the codec's entropy model reads.

From raw Cartesian points: spherical quantization at the KITTI rate point
(radial step qs; bin_num = round(max rho / qs) + 1 angular bins over 2 pi
and pi), the breadth-first octree (levels ascending, cells within a level
in Morton order, octant digit (x << 2) | (y << 1) | z), its occupancy
bytes, and for every node its 4-row context (three ancestors and itself:
level, octant, occupancy 0..254, a missing row (0, 0, 255)) and its cell
origin.  Then the codec's context windows of one level: whole windows of
`csz` nodes, a tail past half a window riding as one more window, a
shorter tail padded to the smallest power-of-two bucket from csz / 8;
positions normalized by the level's (min, max) and quantized to 16 bits,
as the stream's header lets a decoder rebuild them.

Written from the reference codec's serialization (data_preproc/Octree.py
and encode_dataset_ehem.py of SCP / EHEM); it imports nothing of the
program under test.
"""

from __future__ import annotations

import math

import numpy as np

TINY_LEVEL = 512  # levels this small are coded with a uniform prior (no model call)


def spherical_grid(points: np.ndarray, qs: float) -> np.ndarray:
    """(N, 3) Cartesian -> sorted unique non-negative int (rho, phi, theta) cells."""
    p = np.asarray(points, np.float64)
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    rho = np.sqrt(x * x + y * y + z * z)
    phi = np.arctan2(y, x + 1e-9)
    phi = np.where(phi < 0, phi + 2 * math.pi, phi)
    theta = np.arccos(np.clip(z / np.maximum(rho, 1e-30), -1.0, 1.0))
    bins = max(int(np.round(rho.max() / qs) + 1), 2)
    step = np.array([qs, 2 * math.pi / (bins - 1), math.pi / (bins - 1)])
    q = np.round(np.stack([rho, phi, theta], 1) / step).astype(np.int64)
    return np.unique(q, axis=0)


def kitti_qs(lidar_level: int) -> float:
    return 400.0 / (2 ** lidar_level - 1)


class Octree:
    """Breadth-first octree of unique non-negative int points.

    occ (N,) 1..255, level (N,) 1-based, octant (N,) 1..8, parent (N,)
    (-1 for the root), pos (N, 3) cell origins at full resolution,
    sizes [nodes per level]."""

    def __init__(self, pts: np.ndarray):
        pts = np.asarray(pts, np.int64)
        bits = max(int(pts.max()).bit_length(), 1)
        occ, level, octant, parent, pos, sizes = [], [], [], [], [], []
        # a cell at depth d is the per-axis prefix pts >> (bits - d); its Morton
        # key reads one octant digit per depth, most significant first
        prev_key, prev_start = None, 0
        for d in range(bits):
            cells = pts >> (bits - d)
            key = np.zeros(len(pts), np.uint64)
            for j in range(d):
                sh = d - 1 - j
                digit = (((cells[:, 0] >> sh) & 1) << 2) | (((cells[:, 1] >> sh) & 1) << 1) \
                    | ((cells[:, 2] >> sh) & 1)
                key = (key << np.uint64(3)) | digit.astype(np.uint64)
            ukey, first = np.unique(key, return_index=True)
            child = pts >> (bits - d - 1)
            digit = ((child[:, 0] & 1) << 2) | ((child[:, 1] & 1) << 1) | (child[:, 2] & 1)
            node = np.searchsorted(ukey, key)
            byte = np.zeros(len(ukey), np.int64)
            np.bitwise_or.at(byte, node, np.left_shift(1, digit))
            occ.append(byte)
            level.append(np.full(len(ukey), d + 1))
            pos.append(cells[first] << (bits - d))
            if d == 0:
                octant.append(np.ones(1, np.int64))
                parent.append(np.full(1, -1))
            else:
                octant.append((ukey & np.uint64(7)).astype(np.int64) + 1)
                parent.append(prev_start + np.searchsorted(prev_key, ukey >> np.uint64(3)))
            prev_start = sum(sizes)
            sizes.append(len(ukey))
            prev_key = ukey
        self.occ = np.concatenate(occ)
        self.level = np.concatenate(level)
        self.octant = np.concatenate(octant)
        self.parent = np.concatenate(parent)
        self.pos = np.concatenate(pos)
        self.sizes = sizes
        self.max_level = bits

    def contexts(self) -> np.ndarray:
        """(N, 4, 3) int32 rows (great-grandparent, grandparent, parent,
        self) of (level, octant, occupancy 0..254); missing (0, 0, 255)."""
        n = len(self.occ)
        lev = np.concatenate([[0], self.level])
        octn = np.concatenate([[0], self.octant])
        occ = np.concatenate([[255], self.occ - 1])
        up = np.concatenate([[0], self.parent + 1])
        out = np.zeros((n, 4, 3), np.int32)
        row = np.arange(1, n + 1)
        for r in range(3, -1, -1):
            out[:, r] = np.stack([lev[row], octn[row], occ[row]], 1)
            row = up[row]
        return out

    def shard(self) -> np.ndarray:
        """(N, 4, 6) int32 training shard rows (great-grandparent ..
        self): occupancy 1..255 (256 missing), level, octant (0 missing),
        cell origin (0 missing) -- the reference's training data format."""
        n = len(self.occ)
        cols = [np.concatenate([[v], a]) for v, a in ((256, self.occ), (0, self.level),
                                                     (0, self.octant))]
        pos = np.concatenate([np.zeros((1, 3), np.int64), self.pos])
        up = np.concatenate([[0], self.parent + 1])
        out = np.zeros((n, 4, 6), np.int32)
        row = np.arange(1, n + 1)
        for r in range(3, -1, -1):
            out[:, r, :3] = np.stack([c[row] for c in cols], 1)
            out[:, r, 3:] = pos[row]
            row = up[row]
        return out

    def symbols(self) -> np.ndarray:
        """(N,) occupancy symbols 0..254 in breadth-first order."""
        return (self.occ - 1).astype(np.int16)


def level_windows(n: int, csz: int) -> list:
    """[(first node, real nodes, width)] of one level's context windows."""
    full, rem = divmod(n, csz)
    if full and rem * 2 > csz:
        full, rem = full + 1, 0
    out = []
    for i in range(full):
        s = i * csz
        out.append((s, min(csz, n - s), csz))
    if rem:
        b = max(32, csz // 8)
        while b < rem:
            b *= 2
        out.append((full * csz, rem, min(b, csz)))
    return out


def quantized_positions(pos_int: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Per-level min-max normalization, then 16-bit quantization, in f32."""
    pf = (pos_int - lo).astype(np.float32) * np.float32(1.0 / (hi - lo + 1e-9))
    pu = np.round(np.clip(pf, np.float32(0.0), np.float32(1.0)) * np.float32(65535.0))
    return pu.astype(np.int32).astype(np.float32) * np.float32(1.0 / 65535.0)


class SweepContexts:
    """What the entropy model reads for every node of a sweep: per level its
    windows with padded (level, octant, occupancy) rows (the node's own
    occupancy 255), quantized positions and the true symbols."""

    def __init__(self, tree: Octree, csz: int):
        self.tree = tree
        self.csz = csz
        ctx = tree.contexts()
        ctx[:, 3, 2] = 255
        self.ctx = ctx
        self.sym = tree.symbols()
        self.starts = np.concatenate([[0], np.cumsum(tree.sizes)])

    def level_range(self, li: int) -> slice:
        return slice(int(self.starts[li]), int(self.starts[li + 1]))

    def windows(self):
        """Yield (level index, first node, real nodes, data (w, 4, 3), pos
        (w, 3) f32, symbols (w,) with 255 past the real nodes) of every
        modelled window in coding order."""
        for li, n in enumerate(self.tree.sizes):
            if n <= TINY_LEVEL:
                continue
            sl = self.level_range(li)
            pos_int = self.tree.pos[sl]
            lo, hi = int(pos_int.min()), int(pos_int.max())
            pq = quantized_positions(pos_int, lo, hi)
            pad_pos = quantized_positions(np.zeros((1, 3), np.int64), lo, hi)[0]
            for s, m, w in level_windows(n, self.csz):
                d = np.zeros((w, 4, 3), np.int32)
                d[:, :, 2] = 255
                d[:m] = self.ctx[sl][s : s + m]
                p = np.empty((w, 3), np.float32)
                p[:] = pad_pos
                p[:m] = pq[s : s + m]
                y = np.full(w, 255, np.int16)
                y[:m] = self.sym[sl][s : s + m]
                yield li, s, m, d, p, y
