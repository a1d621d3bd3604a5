"""The sweep generator: a frozen copy of the ring-structured LiDAR generator
of the port's bench (scp_tpu_torch/tools/train_bench_ckpt.py::synth_kitti),
kept here so that no change to the program moves the traffic.

A 64-beam ring between -24.8 and +2.0 degrees of elevation, azimuth
uniform, range gamma(3, 8) + 2 m clipped to [2, 120] m.  At 120,000 points
and the spherical KITTI rate point of lidar level 16 a sweep makes about
843k octree nodes in 15 levels.
"""

from __future__ import annotations

import numpy as np


def synth_sweep(rng: np.random.Generator, n: int, beams: int = 64) -> np.ndarray:
    el = np.deg2rad(np.linspace(-24.8, 2.0, beams))[rng.integers(0, beams, n)]
    az = rng.uniform(0, 2 * np.pi, n)
    r = np.clip(rng.gamma(3.0, 8.0, n) + 2.0, 2.0, 120.0)
    return np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az), r * np.sin(el)], 1)


def seed_rng(seed: int, *stream) -> np.random.Generator:
    """A generator for one use of the run's seed (any whole number)."""
    return np.random.default_rng([int(seed) % (1 << 63), *stream])
