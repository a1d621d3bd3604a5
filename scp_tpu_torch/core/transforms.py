"""Copy of scp_tpu/core/transforms.py (the port imports nothing of the
JAX package).

Coordinate transforms: Cartesian <-> spherical / cylindrical.

Numerics match the reference preprocessing (`data_preproc/data_preprocess.py`
:171-229): phi = arctan2(y, x + 1e-9) wrapped to [0, 2*pi), theta =
arccos(z / rho).  Works on any (..., 3) array.
"""

from __future__ import annotations

import numpy as np

_TWO_PI = 2.0 * np.pi


def cart2cylin(points: np.ndarray) -> np.ndarray:
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    rho = np.sqrt(x**2 + y**2)
    phi = np.arctan2(y, x + 1e-9)
    phi = np.where(phi < 0, phi + _TWO_PI, phi)
    return np.stack((rho, phi, z), axis=-1)


def cylin2cart(points: np.ndarray) -> np.ndarray:
    rho, phi, z = points[..., 0], points[..., 1], points[..., 2]
    return np.stack((rho * np.cos(phi), rho * np.sin(phi), z), axis=-1)


def cart2spher(points: np.ndarray) -> np.ndarray:
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    rho = np.sqrt(x**2 + y**2 + z**2)
    phi = np.arctan2(y, x + 1e-9)
    phi = np.where(phi < 0, phi + _TWO_PI, phi)
    theta = np.arccos(np.clip(z / np.maximum(rho, 1e-30), -1.0, 1.0))
    return np.stack((rho, phi, theta), axis=-1)


def spher2cart(points: np.ndarray) -> np.ndarray:
    rho, phi, theta = points[..., 0], points[..., 1], points[..., 2]
    st = np.sin(theta)
    return np.stack(
        (rho * st * np.cos(phi), rho * st * np.sin(phi), rho * np.cos(theta)),
        axis=-1,
    )
