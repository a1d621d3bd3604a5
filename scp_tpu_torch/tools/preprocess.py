"""Training-shard preprocessing CLI (the twin of scp_tpu/tools/preprocess.py;
reference data_preproc/data_preprocess.py __main__, :245-302).

    python -m scp_tpu_torch.tools.preprocess --type kitti \
        --ori_dir 'data/kitti/sequences/*/velodyne/*.bin' \
        --out_dir data/kitti/spher --spher [--parts i/N]

Writes one `<name>_<N>.npy` shard of shape (N, 4, 6) per cloud, byte for
byte scp_tpu's; a cloud whose shard exists is skipped (resume-by-skip,
reference :271-273).  `--parts i/N` takes the i-th of N contiguous slices
of the sorted file list (tools/multi_preproc.py runs the N parts).  Runs
on the host only (numpy and the native octree builder).
"""

from __future__ import annotations

import argparse
import glob
from pathlib import Path

from scp_tpu_torch.core.preprocess import preprocess_file


def get_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--type", type=str, default="kitti", choices=["kitti", "ford"])
    ap.add_argument("--ori_dir", type=str, required=True)
    ap.add_argument("--out_dir", type=str, required=True)
    ap.add_argument("--parts", type=str, default="-1/-1")
    ap.add_argument("--cylin", action="store_true")
    ap.add_argument("--spher", action="store_true")
    return ap.parse_args(argv)


def part_slice(n_files: int, parts: str):
    """(start, end, part, total) of `parts` ("i/N", or "-1/-1" for all)."""
    if parts.startswith("-1"):
        return 0, n_files, 0, 1
    part, total = (int(x) for x in parts.split("/"))
    return n_files * part // total, n_files * (part + 1) // total, part, total


def out_name_for(ori_file: str, data_type: str) -> str:
    p = Path(ori_file)
    if data_type == "ford":
        return p.stem
    # kitti: sequence dir (two levels up) + stem (reference :270)
    return ori_file.split("/")[-3] + p.stem


def main(argv=None):
    args = get_args(argv)
    files = sorted(glob.glob(args.ori_dir))
    existing = {
        f.rsplit("_", 1)[0].split("/")[-1]
        for f in glob.glob(args.out_dir + "/*.npy")
    }
    start, end, part, total = part_slice(len(files), args.parts)

    system = "spher" if args.spher else ("cylin" if args.cylin else "cart")
    qs = 1.0 if args.type == "ford" else 400 / (2**16 - 1)
    for i, f in enumerate(files[start:end]):
        print(f"part {part}/{total}: {i}/{end - start}", flush=True)
        name = out_name_for(f, args.type)
        if name in existing:
            print(f"Already exists: {name}", flush=True)
            continue
        kwargs = dict(system=system, qs=qs)
        if system == "cart":
            kwargs["offset"] = -(2**17) if args.type == "ford" else -200
        preprocess_file(f, args.out_dir, name, **kwargs)


if __name__ == "__main__":
    main()
