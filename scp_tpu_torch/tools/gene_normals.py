"""Normal generation for D2 PSNR on KITTI (the twin of
scp_tpu/tools/gene_normals.py; reference data_preproc/gene_normals.py).

    python -m scp_tpu_torch.tools.gene_normals \
        --ori_dir 'data/kitti/sequences/test/*/velodyne/*.bin' \
        --out_dir data/kitti/test_norm [--parts i/N]

PCA normals over k-NN neighbourhoods (the native KD-tree of
native/src/metrics.cpp), oriented toward the sensor origin; each output .ply carries x,y,z,nx,ny,nz columns, the
format the codec CLI reads through `--normals_dir`.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from scp_tpu_torch.core.pointcloud import read_points
from scp_tpu_torch.metrics import estimate_normals
from scp_tpu_torch.tools.preprocess import part_slice


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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ori_dir", type=str, required=True)
    ap.add_argument("--out_dir", type=str, required=True)
    ap.add_argument("--parts", type=str, default="-1/-1")
    ap.add_argument("--knn", type=int, default=30)
    args = ap.parse_args(argv)

    out_dir = args.out_dir.rstrip("/") + "/"
    os.makedirs(out_dir, exist_ok=True)
    files = sorted(glob.glob(args.ori_dir))
    start, end, part, total = part_slice(len(files), args.parts)
    for i, f in enumerate(files[start:end]):
        print(f"part {part}/{total}: {i}/{end - start}")
        seq_dir = os.path.join(out_dir, f.split("/")[-3])
        os.makedirs(seq_dir, exist_ok=True)
        out_path = os.path.join(seq_dir, os.path.basename(f).split(".")[0] + ".ply")
        pts = read_points(f)
        write_ply_with_normals(out_path, pts, estimate_normals(pts, k=args.knn))


if __name__ == "__main__":
    main()
