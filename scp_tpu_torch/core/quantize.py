"""Copy of scp_tpu/core/quantize.py (the port imports nothing of the
JAX package).

Quantization grids for Cartesian / cylindrical / spherical coordinates.

Reproduces the reference's grid construction (`data_preproc/data_preprocess.py`
:41-70): the radial step `qs` fixes an angular bin count
bin_num = round(max_rho / qs) + 1 whose angle steps are 2*pi/(bin_num-1)
(and pi/(bin_num-1) for the polar angle in spherical mode); a `qlevel`
overrides `qs` with (range / (2^qlevel - 1)) per axis.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from scp_tpu_torch.core.transforms import cart2cylin, cart2spher, cylin2cart, spher2cart


@dataclasses.dataclass
class QuantGrid:
    """Everything needed to map raw Cartesian points <-> integer grid."""

    system: str  # "cart" | "cylin" | "spher"
    qs: np.ndarray  # (3,) step sizes (scalar broadcast for cart)
    offset: np.ndarray  # (3,) subtracted before quantization
    bin_num: int = 0  # angular bin count (0 for cart)

    def to_grid(self, points: np.ndarray) -> np.ndarray:
        """Raw Cartesian points -> integer grid coordinates (not unique)."""
        p = self._transform(points)
        return np.round((p - self.offset) / self.qs).astype(np.int64)

    def from_grid(self, grid_pts: np.ndarray) -> np.ndarray:
        """Integer grid coordinates -> reconstructed Cartesian points."""
        p = grid_pts * self.qs + self.offset
        if self.system == "cylin":
            return cylin2cart(p)
        if self.system == "spher":
            return spher2cart(p)
        return p

    def _transform(self, points: np.ndarray) -> np.ndarray:
        if self.system == "cylin":
            return cart2cylin(points)
        if self.system == "spher":
            return cart2spher(points)
        return np.asarray(points, dtype=np.float64)


def make_grid(
    points: np.ndarray,
    system: str = "cart",
    qs: float = 1.0,
    offset="min",
    qlevel: int | None = None,
) -> QuantGrid:
    """Derive a QuantGrid from data, mirroring reference `proc_pc`."""
    if system == "cylin":
        t = cart2cylin(points)
        # >= 2 bins: a qs larger than the data range would otherwise zero
        # the angular step (and the reference would divide by zero)
        bin_num = max(int(np.round(t[:, 0].max() / qs) + 1), 2)
        qs_vec = np.array([qs, 2.0 * math.pi / (bin_num - 1), qs])
        off = np.array([0.0, 0.0, float(t[:, 2].min())])
    elif system == "spher":
        t = cart2spher(points)
        bin_num = max(int(np.round(t[:, 0].max() / qs) + 1), 2)
        qs_vec = np.array(
            [qs, 2.0 * math.pi / (bin_num - 1), math.pi / (bin_num - 1)]
        )
        off = np.zeros(3)
    else:
        t = np.asarray(points, dtype=np.float64)
        bin_num = 0
        qs_vec = np.array([qs, qs, qs], dtype=np.float64)
        if isinstance(offset, str) and offset == "min":
            off = t.min(axis=0)
        else:
            off = np.broadcast_to(np.asarray(offset, np.float64), (3,)).copy()

    if qlevel is not None:
        shifted = t - off
        if system == "cylin":
            r = shifted[:, 0].max()
            qs_vec = np.array([r, 2.0 * math.pi, r]) / (2**qlevel - 1)
            qs_vec[2] = qs_vec[0]
        elif system == "spher":
            r = shifted[:, 0].max()
            qs_vec = np.array([r, 2.0 * math.pi, math.pi]) / (2**qlevel - 1)
            qs_vec[2] = qs_vec[0]
        else:
            s = (shifted.max() - shifted.min()) / (2**qlevel - 1)
            qs_vec = np.array([s, s, s])

    return QuantGrid(system=system, qs=qs_vec, offset=off, bin_num=bin_num)


def quantize_points(points: np.ndarray, grid: QuantGrid) -> np.ndarray:
    """Quantize to unique sorted integer grid points (reference order:
    np.unique row-sorted, `data_preprocess.py:68-70`)."""
    q = grid.to_grid(points)
    return np.unique(q, axis=0)


def dequantize_points(grid_pts: np.ndarray, grid: QuantGrid) -> np.ndarray:
    return grid.from_grid(grid_pts)
