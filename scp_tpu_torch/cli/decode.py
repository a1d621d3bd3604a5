"""Decode CLI of the port (the twin of scp_tpu/cli/decode.py).

    python -m scp_tpu_torch.cli.decode --ckpt_path <run>/ckpt/<name> \
        --test_files data/.../cloud.ply [--preproc_path dir] --static-knn

Finds the matching .bin in the run's test_output dir, decodes it (with the
ground-truth assert when the preprocessed shard is available — reference
decode_ehem.py:184), and writes the reconstructed .ply.  Takes the
encoder's `--device` and session options (cli/encode.py) and, for an
OctAttention window-schedule stream, its `--sequential` and
`--level_wise`; the header names the schedule, so `--incremental` is not
needed.  A stream stamped with other settings, or written by scp_tpu, is
refused.
"""

from __future__ import annotations

import argparse
import os
import re

import numpy as np

from scp_tpu_torch.cli.encode import add_session_args, resolve_run, session_kwargs


def get_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt_path", type=str, required=True)
    ap.add_argument("--test_files", nargs="*", default=[])
    ap.add_argument("--preproc_path", type=str, default="")
    ap.add_argument("--type", type=str, default="kitti")
    ap.add_argument("--sequential", action="store_true",
                    help="OctAttention window schedule: the encoder's --sequential")
    ap.add_argument("--level_wise", action="store_true",
                    help="OctAttention window schedule: the encoder's --level_wise")
    ap.add_argument("--incremental", action="store_true",
                    help="(no effect: the stream's header names its schedule)")
    ap.add_argument("--mullevel", action="store_true")
    ap.add_argument("--no_check", action="store_true")
    ap.add_argument("--bin_dir", type=str, default=None,
                    help="bitstream directory (default: the run's "
                    "test_output dir — pair of encode's --out_dir)")
    add_session_args(ap)
    return ap.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    from scp_tpu_torch.cli.codec_common import CodecSession, shard_name

    run_dir, out_dir = resolve_run(args.ckpt_path)
    if args.bin_dir:
        out_dir = args.bin_dir
    session = CodecSession(args.ckpt_path, run_dir, **session_kwargs(args))

    test_files = args.test_files
    if test_files and os.path.isdir(test_files[0]):
        d = test_files[0]
        test_files = [os.path.join(d, f) for f in os.listdir(d) if f.endswith(".ply")]

    total = 0.0
    decoded = []
    for i, ori in enumerate(test_files):
        # the encoder names streams shard_name [+ _spher|_cylin] +
        # "_<levels>_<bin>_<z>.bin" (reference_style_name); match the full
        # structure so stem "17" cannot match file "170_..." and stem "a"
        # cannot match "a_b_...".
        stem = shard_name(ori, args.type)
        pat = re.compile(
            re.escape(stem) + r"(_spher|_cylin)?_\d+_\d+_-?\d+\.bin$"
        )
        binfile = None
        for f in sorted(os.listdir(out_dir)):
            if pat.fullmatch(f):
                binfile = os.path.join(out_dir, f)
                break
        if binfile is None:
            print(f"no bitstream for {ori} in {out_dir}")
            continue

        gt = None
        if not args.no_check and args.preproc_path:
            base = os.path.join(args.preproc_path, stem)
            suffixes = ["_0_0", "_0_1", "_1"] if args.mullevel else [""]
            gt = np.concatenate(
                [
                    np.load(base + s + ".npy")[:, -1, 0].astype(np.int16) - 1
                    for s in suffixes
                ]
            )

        out_ply = os.path.join(out_dir, stem + ".ply")
        pts, elapsed = session.decode_file(binfile, out_ply, ground_truth=gt,
                                           sequential=args.sequential,
                                           level_wise=args.level_wise or session.is_ehem)
        decoded.append({"binfile": binfile, "out_ply": out_ply, "points": pts,
                        "seconds": elapsed, "timings": dict(session.timings)})
        total += elapsed
        print(f"decode succeeded, time: {elapsed:.3f}s  points: {len(pts)}")
        print(out_ply)
        print("avg dec time:", total / (i + 1))
    return decoded


if __name__ == "__main__":
    main()
