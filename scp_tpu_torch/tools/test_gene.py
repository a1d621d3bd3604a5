"""Test-data generation CLI (the twin of scp_tpu/tools/test_gene.py;
reference data_preproc/test_gene.py).

    python -m scp_tpu_torch.tools.test_gene --type kitti --lidar_level 16 \
        --ori_dir 'data/kitti/test_norm/*/*.ply' \
        --out_dir data/kitti/spher_mullevel_16 --spher [--mullevel] [--parts i/N]

Per cloud, writes the context shard(s) (`<name>.npy`, or the `_0_0`,
`_0_1`, `_1` subtrees with --mullevel), `<name>_quant.ply` of the
dequantized points, `<name>_meta.npy` = [bin_num, chamfer(, z_offset)]
(reference test_gene.py:65,87,106) and `<name>_manifest.npz` with each
subtree's quantization grid (read by the encode CLI's `--preproc_path`).
Runs on the host only: numpy, the native octree builder and the native
KD-tree of the metrics.
"""

from __future__ import annotations

import argparse
import glob
import os
from pathlib import Path

import numpy as np

from scp_tpu_torch.core.pointcloud import read_points, write_ply
from scp_tpu_torch.core.preprocess import ford_qs, kitti_qs, preprocess_points
from scp_tpu_torch.metrics import chamfer
from scp_tpu_torch.tools.preprocess import part_slice

MULLEVEL_PATHS = ([0, 0], [0, 1], [1])
MULLEVEL_SUFFIX = ("_0_0", "_0_1", "_1")


def get_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--type", type=str, default="kitti", choices=["kitti", "ford"])
    ap.add_argument("--ori_dir", type=str, required=True)
    ap.add_argument("--out_dir", type=str, required=True)
    ap.add_argument("--parts", type=str, default="-1/-1")
    ap.add_argument("--lidar_level", type=int, default=16)
    ap.add_argument("--cylin", action="store_true")
    ap.add_argument("--spher", action="store_true")
    ap.add_argument("--mullevel", action="store_true")
    return ap.parse_args(argv)


def qs_for(data_type: str, level: int) -> float:
    return kitti_qs(level) if data_type == "kitti" else ford_qs(level)


def out_name_for(ori_file: str, data_type: str) -> str:
    """kitti: the parent directory's name + the stem; ford: the stem."""
    p = Path(ori_file)
    return str(p.parent).split("/")[-1] + p.stem if data_type == "kitti" else p.stem


def generate_one(ori_file: str, out_dir: str, out_name: str, args) -> None:
    system = "spher" if args.spher else ("cylin" if args.cylin else "cart")
    pts = read_points(ori_file)
    results = []
    if args.mullevel:
        for j, mp in enumerate(MULLEVEL_PATHS):
            res = preprocess_points(pts, system=system, qs=qs_for(args.type, args.lidar_level + j),
                                    morton_path=mp)
            results.append(res)
            np.save(os.path.join(out_dir, out_name + MULLEVEL_SUFFIX[j]), res.context)
    else:
        res = preprocess_points(
            pts, system=system, qs=qs_for(args.type, args.lidar_level),
            offset=(-200 if args.type == "kitti" else -(2**17)) if system == "cart" else 0,
        )
        results.append(res)
        np.save(os.path.join(out_dir, out_name), res.context)

    quant = np.vstack([r.recon_points for r in results])
    write_ply(os.path.join(out_dir, out_name + "_quant.ply"), quant)
    cd = chamfer(pts.copy(), quant.copy())
    first = results[0]
    meta = [first.bin_num, cd]
    if args.cylin or args.mullevel:
        meta.append(first.z_offset)
    np.save(os.path.join(out_dir, out_name + "_meta"), np.array(meta))
    np.savez(
        os.path.join(out_dir, out_name + "_manifest.npz"),
        qs=np.stack([r.grid.qs for r in results]),
        offset=np.stack([r.grid.offset for r in results]),
        bin_num=np.array([r.grid.bin_num for r in results]),
        system=system,
        max_levels=np.array([r.tree.max_level for r in results]),
    )


def main(argv=None):
    args = get_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    files = sorted(glob.glob(args.ori_dir))
    start, end, part, total = part_slice(len(files), args.parts)
    for i, f in enumerate(files[start:end]):
        generate_one(f, args.out_dir, out_name_for(f, args.type), args)
        print(f"part {part}/{total}: {i}/{end - start}")


if __name__ == "__main__":
    main()
