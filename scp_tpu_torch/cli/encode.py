"""Encode CLI of the port (the twin of scp_tpu/cli/encode.py).

    python -m scp_tpu_torch.cli.encode --ckpt_path <run>/ckpt/<name> \
        --type kitti --lidar_level 16 --spher --static-knn \
        --preproc_path data/kitti/spher_16/ --test_files 'data/.../*.ply'

An OctAttention run (config `model.class_name: OctAttention`) codes with
the window schedule by default (host coder; `--sequential` slides the
window, `--level_wise` restarts it at every level), and with the
incremental KV-cache schedule under `--incremental`: on the device rANS
coder (`--octattn-coder rans`, the default; the fused level loop, or
scp_tpu's per-position loop under `--octattn-steps`) or on the host coder
(`--octattn-coder full`).

Reads the run's config, loads the checkpoint (the trainer's .pt or a
bench .npz), preprocesses (or reuses cached shards), entropy-codes each
cloud, writes the bitstream (reference-style filename + self-contained
header) and reports bpp / bits-per-node / PSNR / Chamfer / model seconds,
appending the aggregate of a glob to test_results_same_<type>_<level>.txt
in the working directory (reference encode.py:293-305).

An EHEM run codes in `--ehem-mode rans` (the device rANS coder, the
default), `staged` (two 16-way nibble stages on the host coder) or `full`
(one 256-entry row per node on the host coder); the header names the
mode, and the decoder follows it.

Runs on the card unless given `--device cpu`.  `--dtype`, `--ehem-mode`,
`--static-knn`, `--pallas-knn`, `--pallas-attn`, `--octattn-coder`,
`--octattn-steps` and `--octrans-cap` stand for scp_tpu's
SCP_CODEC_DTYPE, SCP_CODEC_MODE, SCP_STATIC_KNN, SCP_PALLAS_KNN,
SCP_PALLAS_ATTN, SCP_OCTATTN_CODER, SCP_OCTATTN_FUSED=0 and
SCP_OCTRANS_CAP; the decoder must be given the same ones except the mode
(the stream's stamp names them).
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from scp_tpu_torch.codec.ehem_codec import MODES as EHEM_MODES
from scp_tpu_torch.codec.octattn_rans import DEFAULT_CAP


def add_session_args(ap: argparse.ArgumentParser) -> None:
    """The options every codec CLI of the port takes (cli/train.py's names)."""
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default cuda; cpu runs the plain PyTorch path)")
    ap.add_argument("--dtype", type=str, default=None, choices=["bf16", "f32"],
                    help="compute dtype of the model (SCP_CODEC_DTYPE; default bf16 for "
                    "EHEM, f32 for OctAttention)")
    ap.add_argument("--ehem-mode", type=str, default=None, choices=list(EHEM_MODES),
                    help="EHEM's coding mode: device rANS, staged nibbles or full rows on "
                    "the host coder (SCP_CODEC_MODE; default rans; decode reads it from "
                    "the header)")
    ap.add_argument("--static-knn", action="store_true",
                    help="reuse the position graph in every EdgeConv (SCP_STATIC_KNN)")
    ap.add_argument("--pallas-knn", action="store_true",
                    help="kernel D for graphs of N >= 2048 rows (SCP_PALLAS_KNN)")
    ap.add_argument("--pallas-attn", action="store_true",
                    help="kernel E in the padded Swin stages (SCP_PALLAS_ATTN)")
    ap.add_argument("--octattn-coder", type=str, default="rans", choices=["rans", "full"],
                    help="OctAttention's incremental coder: device rANS or the host "
                    "coder (SCP_OCTATTN_CODER)")
    ap.add_argument("--octattn-steps", action="store_true",
                    help="OctAttention rANS: the per-position loop instead of the fused "
                    "level loop (SCP_OCTATTN_FUSED=0)")
    ap.add_argument("--octrans-cap", type=int, default=DEFAULT_CAP,
                    help="OctAttention rANS: the stream buffer's bytes (SCP_OCTRANS_CAP)")


def session_kwargs(args) -> dict:
    return dict(dtype=args.dtype, ehem_mode=args.ehem_mode, static_knn=args.static_knn,
                pallas_knn=args.pallas_knn, pallas_attn=args.pallas_attn,
                octattn_coder=args.octattn_coder,
                octattn_fused=not args.octattn_steps, octrans_cap=args.octrans_cap,
                device=args.device)


def get_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt_path", type=str, required=True)
    ap.add_argument("--test_files", nargs="*", default=[])
    ap.add_argument("--sequential", action="store_true",
                    help="OctAttention: slide the window by one node")
    ap.add_argument("--incremental", action="store_true",
                    help="OctAttention: the KV-cache schedule (see --octattn-coder)")
    ap.add_argument("--type", type=str, default="obj", choices=["obj", "kitti", "ford"])
    ap.add_argument("--lidar_level", type=int, default=12)
    ap.add_argument("--level_wise", action="store_true",
                    help="OctAttention window schedule: restart the window at every level "
                    "(EHEM always codes level by level)")
    ap.add_argument("--cylin", action="store_true")
    ap.add_argument("--spher", action="store_true")
    ap.add_argument("--mullevel", action="store_true")
    ap.add_argument("--preproc_path", type=str, default="")
    ap.add_argument("--normals_dir", type=str, default="",
                    help="dir of <stem>.ply normals (scp_tpu's tools/gene_normals) "
                    "enabling D2 PSNR, reference pt.py:68-79 -n flag")
    ap.add_argument("--out_dir", type=str, default=None)
    add_session_args(ap)
    return ap.parse_args(argv)


def _fmt_psnr(vals) -> str:
    """Mean PSNR, or "N/A" for cached-preproc runs (PSNR never measured —
    the per-file values are NaN, distinct from a measured zero)."""
    a = np.asarray(vals, np.float64)
    if np.isnan(a).all():
        return "N/A"
    return str(float(np.nanmean(a)))


def resolve_run(ckpt_path: str):
    """<run_dir>/ckpt/<name> -> (run_dir, test_output dir).

    Splits on the `ckpt` PATH COMPONENT (a run dir whose name merely
    contains the substring, e.g. `outputs/bench_ckpt`, must not match)."""
    parts = ckpt_path.replace(os.sep, "/").rstrip("/").split("/")
    if "ckpt" not in parts:
        raise SystemExit(
            f"--ckpt_path must point inside a <run>/ckpt/ directory: {ckpt_path}"
        )
    i = len(parts) - 1 - parts[::-1].index("ckpt")
    run_dir = "/".join(parts[:i]) or "."
    name = "/".join(parts[i + 1 :])
    return run_dir, os.path.join(run_dir, "test_output", name)


def main(argv=None):
    args = get_args(argv)
    from scp_tpu_torch.cli.codec_common import CodecSession

    run_dir, out_dir = resolve_run(args.ckpt_path)
    if args.out_dir:
        out_dir = args.out_dir
    session = CodecSession(args.ckpt_path, run_dir, **session_kwargs(args))

    test_files = args.test_files
    combine = False
    if test_files and "*" in test_files[0]:
        test_files = sorted(glob.glob(test_files[0]))
        combine = True

    system = "spher" if args.spher else ("cylin" if args.cylin else "cart")
    bpps, times, psnrs, psnrs_d2, chamfers, all_stats = [], [], [], [], [], []
    for i, f in enumerate(test_files):
        print(f"Encoding {f} {i}/{len(test_files)}")
        stats = session.encode_file(
            f,
            out_dir,
            data_type=args.type,
            lidar_level=args.lidar_level,
            system=system,
            preproc_path=args.preproc_path,
            sequential=args.sequential,
            incremental=args.incremental,
            mullevel=args.mullevel,
            level_wise=args.level_wise,
            normals_dir=args.normals_dir,
        )
        all_stats.append({**stats, "timings": dict(session.timings)})
        bpps.append(stats["bpp"])
        times.append(stats["seconds"])
        psnrs.append(stats["psnr_d1"])
        psnrs_d2.append(stats["psnr_d2"])
        chamfers.append(stats["chamfer"])
        for k in ("outputfile", "seconds", "pt_num", "oct_num", "bits",
                  "bit_per_oct", "bpp"):
            print(f"{k:28s}: {stats[k]}")
        print(
            _fmt_psnr(psnrs), np.mean(bpps), np.mean(chamfers), np.mean(times)
        )

    if combine and test_files:
        d2_line = (
            f"PSNR_D2: {_fmt_psnr(psnrs_d2)}\n" if args.normals_dir else ""
        )
        out = (
            f"same {args.lidar_level} {args.test_files} {args.ckpt_path}\n"
            f"sample number: {len(bpps)}\ntimes: {float(np.mean(times))}\n"
            f"bpp: {float(np.mean(bpps))}\nchamfer_dist: {float(np.mean(chamfers))}\n"
            f"PSNR: {_fmt_psnr(psnrs)}\n{d2_line}\n"
        )
        with open(f"test_results_same_{args.type}_{args.lidar_level}.txt", "a") as fh:
            fh.write(out)
        print("bpp:", float(np.mean(bpps)))
    return all_stats


if __name__ == "__main__":
    main()
