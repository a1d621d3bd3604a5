"""The normals ply format of D2 PSNR on KITTI (the readers and writers of
scp_tpu/tools/gene_normals.py, which the codec CLI reads through
`--normals_dir`).

The tool's `main` (normals for a directory of sweeps) waits for the port
of scp_tpu/tools/preprocess.py (ROADMAP.md).
"""

from __future__ import annotations

import os

import numpy as np


def write_ply_with_normals(path: str, points: np.ndarray, normals: np.ndarray):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    header = (
        "ply\n"
        "format ascii 1.0\n"
        f"element vertex {points.shape[0]}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property float32 nx\nproperty float32 ny\nproperty float32 nz\n"
        "end_header"
    )
    np.savetxt(
        path,
        np.hstack([points, normals]),
        fmt="%f",
        header=header,
        comments="",
    )


def read_normals_ply(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read x,y,z + nx,ny,nz columns from an ASCII normals ply."""
    with open(path) as f:
        line = f.readline()
        while not line.strip() == "end_header":
            line = f.readline()
        data = np.loadtxt(f)
    return data[:, :3].astype(np.float32), data[:, 3:6].astype(np.float32)
