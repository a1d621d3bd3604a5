"""Level-wise slicing of (N, 4, 6) context arrays for the codecs.

Equivalent role to the reference's EncodeEHEMDataset / EncodeDataset
level-splitting (`dataloaders/encode_dataset_ehem.py:55-105`,
`encode_dataset.py:32-55`), as a pure function over the preprocessed array.

Copy of scp_tpu/codec/slices.py: the port keeps its own copy so that it
imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from scp_tpu_torch.utils import profiling

BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)


def bucket_for(n: int, max_bucket: int = 8192) -> int:
    for b in BUCKETS:
        if b >= n and b <= max_bucket:
            return b
    return max_bucket


def softmax_np(logits: np.ndarray) -> np.ndarray:
    """Stable softmax in float32 — the ONE softmax both encoder and decoder
    use, so quantized CDFs agree bit-for-bit (and stay cheap on the host)."""
    x = logits.astype(np.float32)
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


@dataclasses.dataclass
class LevelSlices:
    """Per-octree-level views of one cloud's context array."""

    data: list[np.ndarray]  # per level: (n_l, 4, 3) int32 (level, octant, occ)
    pos_int: list[np.ndarray]  # per level: (n_l, 3) int64 current-node grid pos
    pos_mm: list[tuple[int, int]]  # per level (min, max) of pos_int (spher/cylin)
    occ_stream: np.ndarray  # (N,) int16 symbols 0..254 in BFS order
    level_of: np.ndarray  # (N,) level per node
    max_level: int
    angular: bool  # True: per-level min-max pos norm; False: /2^max_level

    @property
    def num_levels(self) -> int:
        return len(self.data)

    @property
    def level_sizes(self) -> list[int]:
        """Per-level node counts — written to the stream header so the
        decoder knows every level's shape up front (the whole wavefront
        can then be dispatched device-resident, no per-level sync)."""
        return [int(d.shape[0]) for d in self.data]

    def level_pos(self, l: int) -> np.ndarray:
        """Float32 normalized positions for level index l (0-based)."""
        return normalize_positions(
            self.pos_int[l], self.pos_mm[l], self.max_level, self.angular
        )


def normalize_positions(pos_int, mm, max_level: int, angular: bool) -> np.ndarray:
    """The shared (encoder == decoder) position normalization.

    angular (spher/cylin): per-level min-max (reference
    encode_dataset_ehem.py:69-74 — here with min AND max recorded so decode
    is exact; the reference's single-level decoder assumed min == 0,
    decode_ehem.py:41-53).
    cartesian: divide by 2^max_level (encode_dataset_ehem.py:75)."""
    if angular:
        lo, hi = mm
        return ((pos_int - lo) / (hi - lo + 1e-9)).astype(np.float32)
    return (pos_int / float(2**max_level)).astype(np.float32)


def split_levels(ctx: np.ndarray, angular: bool, lidar_level_clip: int | None = None) -> LevelSlices:
    """ctx: raw (N, 4, 6) shard (occupancy still 1..255)."""
    with profiling.span("preprocess.split"):
        return _split_levels(np.asarray(ctx), angular, lidar_level_clip)


def _split_levels(ctx: np.ndarray, angular: bool, lidar_level_clip) -> LevelSlices:
    occ = ctx[:, :, 0].astype(np.int32) - 1  # 0..254; pad 256 -> 255
    levels = ctx[:, :, 1].astype(np.int32)
    octants = ctx[:, :, 2].astype(np.int32)
    node_level = levels[:, -1]
    max_level = int(node_level.max())

    data_all = np.stack([levels, octants, occ], axis=-1)  # (N, 4, 3)
    pos_all = ctx[:, -1, 3:6].astype(np.int64)

    data, pos_int, pos_mm = [], [], []
    for l in range(1, max_level + 1):
        sel = node_level == l
        d = data_all[sel]
        p = pos_all[sel]
        if lidar_level_clip is not None and l == max_level:
            # The reference clips the level channel (all K ancestor slots)
            # of the DEEPEST level's rows only (encode_dataset_ehem.py:86
            # applies after the per-level loop; inner levels pass through)
            # — this is what keeps multi-level subtrees (depth up to
            # lidar_level+2) inside the level-embedding table.
            d = d.copy()
            d[:, :, 0] = np.minimum(d[:, :, 0], lidar_level_clip)
        data.append(d.astype(np.int32))
        pos_int.append(p)
        pos_mm.append((int(p.min()), int(p.max())) if p.size else (0, 0))
    return LevelSlices(
        data=data,
        pos_int=pos_int,
        pos_mm=pos_mm,
        occ_stream=occ[:, -1].astype(np.int16),
        level_of=node_level,
        max_level=max_level,
        angular=angular,
    )


def pad_rows(data: np.ndarray, pos: np.ndarray, target: int):
    """Pad a (m, 4, 3) level chunk + (m, 3) positions to `target` rows with
    the unknown token (occ 255, level/octant/pos 0)."""
    m = data.shape[0]
    if m == target:
        return data, pos
    pad_d = np.zeros((target - m, data.shape[1], 3), data.dtype)
    pad_d[:, :, 2] = 255
    pad_p = np.zeros((target - m, 3), pos.dtype)
    return np.concatenate([data, pad_d]), np.concatenate([pos, pad_p])
