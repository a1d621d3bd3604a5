"""Single-scan EHEM encode + decode throughput of the port on the card (the
twin of the root bench.py's single-scan measurement).

    python -m scp_tpu_torch.tools.bench [--passes 5]

The bench sweep (the ring-structured generator, seed 0, 120,000 points),
spherical at lidar level 16 (kitti_qs(16)), the full-width EHEM from
checkpoints/ehem_synth_f16_sknn.npz with static KNN, bf16, context 8192:
one warm encode + decode, then `--passes` (default BENCH_PASSES, else 5)
timed passes of encode + decode with the lossless check; the best pass is
kept.  Prints the card's `nvidia-smi` name and power limit on a `#` line
first, a `#` line per pass, and last the JSON record
{"metric": "ehem_enc_dec_points_per_sec_L16", "value", "unit", "vs_baseline"}.
Runs on the card only; without one it raises.

vs_baseline: the reference (PyTorch EHEM on one A100-class GPU) codes
roughly 6e4 points/sec through encode + decode at KITTI L16 (the root
bench.py's yardstick, SURVEY.md section 6).  `--pipeline k` (several
clouds in flight) is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

BASELINE_POINTS_PER_SEC = 6.0e4
N_POINTS = 120_000
LIDAR_LEVEL = 16
HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CKPT = os.path.join(HERE, "checkpoints", "ehem_synth_f16_sknn.npz")


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(codec, slices, n_points: int, passes: int, log=print) -> dict:
    """One warm encode + decode, then `passes` timed ones (host wall, each
    ending in a device sync); returns the best pass's record and times."""
    best = None
    for i in range(passes + 1):
        _sync(codec.device)
        t0 = time.perf_counter()
        stream, bits, _ = codec.encode_to_stream(slices)
        _sync(codec.device)
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        dec = codec.new_stream_decoder(stream, codec.ac_symbols_per_node * len(slices.occ_stream))
        codes = codec.decode(dec, slices.max_level, np.array(slices.pos_mm, np.int64),
                             angular=slices.angular, ground_truth=slices.occ_stream,
                             level_sizes=slices.level_sizes)
        _sync(codec.device)
        t_dec = time.perf_counter() - t0
        if not (codes == slices.occ_stream).all():
            raise AssertionError("decode is not lossless")
        log(f"# {'warm' if i == 0 else f'pass {i - 1}'}: enc={t_enc:.4f}s dec={t_dec:.4f}s "
            f"bytes={len(stream)}")
        if i and (best is None or t_enc + t_dec < best["encode_s"] + best["decode_s"]):
            best = dict(encode_s=t_enc, decode_s=t_dec, bits=bits)
    pps = n_points / (best["encode_s"] + best["decode_s"])
    record = {"metric": "ehem_enc_dec_points_per_sec_L16", "value": round(pps, 1),
              "unit": "points/sec", "vs_baseline": round(pps / BASELINE_POINTS_PER_SEC, 3)}
    return {"record": record, **best, "bpp": best["bits"] / n_points}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=int(os.environ.get("BENCH_PASSES", "5")))
    args = ap.parse_args(argv)

    import torch

    from scp_tpu_torch import resolve_device

    device = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"# {smi}", flush=True)

    from scp_tpu_torch.codec.ehem_codec import EHEMCodec
    from scp_tpu_torch.codec.slices import split_levels
    from scp_tpu_torch.core.preprocess import kitti_qs, preprocess_points
    from scp_tpu_torch.models.ehem import EHEM
    from scp_tpu_torch.tools.train_bench_ckpt import synth_kitti
    from scp_tpu_torch.weights import load_into

    t_start = time.time()
    pts = synth_kitti(np.random.default_rng(0), N_POINTS)
    t0 = time.time()
    res = preprocess_points(pts, system="spher", qs=kitti_qs(LIDAR_LEVEL))
    slices = split_levels(res.context, angular=True)
    t_pre = time.time() - t0
    model = load_into(EHEM(static_knn=True, dtype=torch.bfloat16, device=device), CKPT)
    codec = EHEMCodec(model, context_size=8192)
    out = measure(codec, slices, N_POINTS, args.passes)
    print(f"# device={torch.cuda.get_device_name(device)} n_points={N_POINTS} "
          f"nodes={len(slices.occ_stream)} pre={t_pre:.3f}s (octree {res.octree_s:.3f}s) "
          f"enc={out['encode_s']:.4f}s dec={out['decode_s']:.4f}s bpp={out['bpp']:.4f} "
          f"total wall {time.time() - t_start:.1f}s", flush=True)
    print(json.dumps(out["record"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
