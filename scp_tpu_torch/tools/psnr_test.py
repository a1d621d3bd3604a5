"""Preprocessing-quality checker (the twin of scp_tpu/tools/psnr_test.py;
reference data_preproc/psnr_test.py): D1/D2 PSNR and Chamfer of the
`<name>_quant.ply` reconstructions that tools/test_gene.py writes, against
the original clouds.

    python -m scp_tpu_torch.tools.psnr_test --type kitti \
        --ori_dir 'data/kitti/test_norm/*/*.ply' --quant_dir data/kitti/spher_16 \
        [--with_normals]

`--with_normals`: the original files are normals plys (x, y, z, nx, ny,
nz; tools/gene_normals.py), which give D2.  Runs on the host (the native
KD-tree).
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from scp_tpu_torch.core.pointcloud import read_points
from scp_tpu_torch.metrics import PEAKS, chamfer, d1_d2_psnr
from scp_tpu_torch.tools.gene_normals import read_normals_ply
from scp_tpu_torch.tools.test_gene import out_name_for


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--type", type=str, default="kitti", choices=["kitti", "ford"])
    ap.add_argument("--ori_dir", type=str, required=True)
    ap.add_argument("--quant_dir", type=str, required=True)
    ap.add_argument("--with_normals", action="store_true",
                    help="ori files carry normals (gene_normals output)")
    args = ap.parse_args(argv)

    files = sorted(glob.glob(args.ori_dir))
    peak = PEAKS[args.type]
    d1s, d2s, cds = [], [], []
    for f in files:
        name = out_name_for(f, args.type)
        qf = os.path.join(args.quant_dir, name + "_quant.ply")
        if not os.path.exists(qf):
            print("missing", qf)
            continue
        if args.with_normals:
            pts, normals = read_normals_ply(f)
        else:
            pts, normals = read_points(f), None
        quant = read_points(qf)
        d1, d2 = d1_d2_psnr(pts, quant, peak, normals)
        cd = chamfer(pts.copy(), quant.copy())
        d1s.append(d1)
        d2s.append(d2)
        cds.append(cd)
        print(f"{name}: D1 {d1:.3f}  D2 {d2:.3f}  chamfer {cd:.5f}")
    if d1s:
        print(
            f"mean over {len(d1s)}: D1 {np.mean(d1s):.3f} "
            f"D2 {np.mean(d2s):.3f} chamfer {np.mean(cds):.5f}"
        )
    return {"d1": d1s, "d2": d2s, "chamfer": cds}


if __name__ == "__main__":
    main()
