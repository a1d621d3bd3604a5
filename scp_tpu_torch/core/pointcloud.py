"""Copy of scp_tpu/core/pointcloud.py (the port imports nothing of the
JAX package).

Point-cloud I/O and geometric metrics.

Formats match the reference reader set (`data_preproc/pt.py:162-281`):
ASCII/binary .ply, KITTI .bin (float32 x,y,z,intensity), .h5 ("data"
dataset).  plyfile/open3d are not required: .ply parsing is self-contained.
"""

from __future__ import annotations

import os

import numpy as np


def read_points(path: str) -> np.ndarray:
    """Load (N, 3) float32 coordinates from .ply / .bin / .h5 / .npy."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if path.endswith(".ply"):
        return read_ply(path)
    if path.endswith(".bin"):
        return read_kitti_bin(path)
    if path.endswith(".h5"):
        import h5py

        with h5py.File(path, "r") as f:
            return np.asarray(f["data"][:, 0:3], dtype=np.float32)
    if path.endswith(".npy"):
        return np.load(path)[:, 0:3].astype(np.float32)
    raise ValueError(f"unsupported point cloud format: {path}")


def read_kitti_bin(path: str) -> np.ndarray:
    pts = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return pts[:, 0:3]


def read_ply(path: str) -> np.ndarray:
    """Minimal .ply reader: ASCII and binary_little_endian, xyz floats."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        count = next(
            int(l.split()[-1]) for l in header if l.startswith("element vertex")
        )
        props = [
            (l.split()[1], l.split()[2])
            for l in header
            if l.startswith("property") and not l.startswith("property list")
        ]
        type_map = {
            "float": "f4",
            "float32": "f4",
            "double": "f8",
            "float64": "f8",
            "uchar": "u1",
            "uint8": "u1",
            "char": "i1",
            "int8": "i1",
            "short": "i2",
            "int16": "i2",
            "ushort": "u2",
            "uint16": "u2",
            "int": "i4",
            "int32": "i4",
            "uint": "u4",
            "uint32": "u4",
        }
        names = [p[1] for p in props]
        if fmt == "ascii":
            data = np.loadtxt(f, dtype=np.float64, max_rows=count).reshape(count, -1)
            cols = {n: data[:, i] for i, n in enumerate(names)}
        else:
            endian = "<" if "little" in fmt else ">"
            dt = np.dtype([(n, endian + type_map[t]) for t, n in props])
            raw = np.frombuffer(f.read(count * dt.itemsize), dtype=dt, count=count)
            cols = {n: raw[n] for n in names}
        out = np.stack(
            [cols["x"], cols["y"], cols["z"]], axis=1
        ).astype(np.float32)
        return out


def write_ply(path: str, points: np.ndarray) -> None:
    """ASCII .ply writer (geometry only), reference-compatible header
    (`pt.py:116-153`)."""
    points = np.asarray(points)
    d = os.path.dirname(path)
    if d and not os.path.exists(d):
        os.makedirs(d, exist_ok=True)
    header = (
        "ply\n"
        "format ascii 1.0\n"
        f"element vertex {points.shape[0]}\n"
        "property float x\n"
        "property float y\n"
        "property float z\n"
        "end_header"
    )
    np.savetxt(path, points[:, :3], fmt="%f", header=header, comments="")


def chamfer_distance(a: np.ndarray, b: np.ndarray, scale: float = 1.0) -> float:
    """max(mean 1-NN dist a->b, b->a); reference `distChamfer` (`pt.py:88-95`)."""
    from scipy.spatial import KDTree

    a = np.asarray(a, dtype=np.float64) / scale
    b = np.asarray(b, dtype=np.float64) / scale
    d_ab, _ = KDTree(a, compact_nodes=False).query(b, k=1, workers=-1)
    d_ba, _ = KDTree(b, compact_nodes=False).query(a, k=1, workers=-1)
    return float(max(d_ab.mean(), d_ba.mean()))
