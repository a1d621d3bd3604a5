"""Single-scan EHEM encode + decode throughput of the port on the card (the
twin of the root bench.py's single-scan measurement).

    python -m scp_tpu_torch.tools.bench [--passes 5] [--pipeline K] [--devices N]
        [--ckpt PATH] [--dynamic-knn] [--pallas-knn]

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
bench.py's yardstick, SURVEY.md section 6).

`--pipeline K` (K > 1; the root bench.py's throughput mode, reported
beside the single scan, never in its place): K clouds in flight through
one codec, the bench sweep and K - 1 more (seeds 100, 101, ...).  Every
encode is dispatched before any payload is fetched, the decodes run as
interleaved level generators (`decode_steps`), each cloud is checked
lossless; one warm run, then the best of two.  The record gains
{"pipeline": {"clouds", "points_per_sec", "x_single_scan"}}.

`--devices N` codes on the sharded codec (EHEMCodec(devices=...)): N lane
shards on cuda:0 .. cuda:N-1, wrapping around the visible cards (two
shards on one card with N = 2 there); the record gains "devices": N.

The model (the root bench.py's BENCH_CKPT and SCP_STATIC_KNN, as flags):
`--dynamic-knn` turns static KNN off (EdgeConv 2 and 3 rebuild their
graphs on their features, JAX's default DGCNN) and then loads
checkpoints/ehem_synth_f16.npz, the checkpoint trained on that graph;
`--ckpt PATH` loads another npz (with static KNN unless `--dynamic-knn`);
`--pallas-knn` sends graphs of N >= 2048 rows to kernel D.  Any of them
adds "model": {"ckpt", "static_knn", "pallas_knn"} to the record.
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
DYNAMIC_CKPT = os.path.join(HERE, "checkpoints", "ehem_synth_f16.npz")


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


def pipeline_bench(codec, slices_list):
    """K clouds in flight through one codec (bench.py:83-130): every
    encode dispatched before any finish_stream, the decodes interleaved
    level by level.  Returns (wall seconds, streams, decoded codes); each
    cloud is checked lossless."""
    t0 = time.perf_counter()
    encs = []
    for sl in slices_list:
        enc = codec.new_stream_encoder()
        codec.encode_into(enc, sl)
        encs.append(enc)
    streams = [codec.finish_stream(enc)[0] for enc in encs]
    gens = [codec.decode_steps(codec.new_stream_decoder(st, len(sl.occ_stream)), sl.max_level,
                               np.array(sl.pos_mm, np.int64), angular=sl.angular,
                               ground_truth=sl.occ_stream, level_sizes=sl.level_sizes)
            for sl, st in zip(slices_list, streams)]
    codes = [None] * len(gens)
    live = list(range(len(gens)))
    while live:
        for i in list(live):
            try:
                next(gens[i])
            except StopIteration as e:
                codes[i] = e.value
                live.remove(i)
    _sync(codec.device)
    wall = time.perf_counter() - t0
    for sl, c in zip(slices_list, codes):
        if not (c == sl.occ_stream).all():
            raise AssertionError("pipelined decode is not lossless")
    return wall, streams, codes


def shard_devices(n: int) -> list:
    """n lane-shard devices over the visible cards, round robin."""
    import torch

    count = torch.cuda.device_count()
    return [f"cuda:{i % count}" for i in range(n)]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=int(os.environ.get("BENCH_PASSES", "5")))
    ap.add_argument("--pipeline", type=int, default=0, help="K clouds in flight (K > 1)")
    ap.add_argument("--devices", type=int, default=1, help="lane shards (sharded codec)")
    ap.add_argument("--ckpt", default=None,
                    help="weights npz (default: the sknn checkpoint; ehem_synth_f16.npz "
                         "with --dynamic-knn)")
    ap.add_argument("--dynamic-knn", action="store_true",
                    help="static KNN off: the dynamic graph (the root bench's SCP_STATIC_KNN=0)")
    ap.add_argument("--pallas-knn", action="store_true",
                    help="kernel D builds the graphs of N >= 2048 rows")
    return ap.parse_args(argv)


def ckpt_path(args) -> str:
    return args.ckpt or (DYNAMIC_CKPT if args.dynamic_knn else CKPT)


def build_model(args, device):
    """The bench's bf16 EHEM with the flags' checkpoint and switches."""
    import torch

    from scp_tpu_torch.models.ehem import EHEM
    from scp_tpu_torch.weights import load_into

    return load_into(EHEM(static_knn=not args.dynamic_knn, pallas_knn=args.pallas_knn,
                          dtype=torch.bfloat16, device=device), ckpt_path(args))


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch

    from scp_tpu_torch import resolve_device

    device = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"# {smi}", flush=True)

    from scp_tpu_torch.codec.ehem_codec import EHEMCodec
    from scp_tpu_torch.codec.slices import split_levels
    from scp_tpu_torch.core.preprocess import kitti_qs, preprocess_points
    from scp_tpu_torch.tools.train_bench_ckpt import synth_kitti

    t_start = time.time()
    pts = synth_kitti(np.random.default_rng(0), N_POINTS)
    t0 = time.time()
    res = preprocess_points(pts, system="spher", qs=kitti_qs(LIDAR_LEVEL))
    slices = split_levels(res.context, angular=True)
    t_pre = time.time() - t0
    model = build_model(args, device)
    devices = shard_devices(args.devices) if args.devices > 1 else None
    codec = EHEMCodec(model, context_size=8192, devices=devices)
    out = measure(codec, slices, N_POINTS, args.passes)
    if devices:
        out["record"]["devices"] = args.devices
    if args.ckpt or args.dynamic_knn or args.pallas_knn:
        out["record"]["model"] = {
            "ckpt": os.path.basename(ckpt_path(args)),
            "static_knn": model.static_knn, "pallas_knn": model.pallas_knn}
    k = args.pipeline
    if k > 1:
        batch = [slices] + [
            split_levels(preprocess_points(synth_kitti(np.random.default_rng(100 + i), N_POINTS),
                                           system="spher", qs=kitti_qs(LIDAR_LEVEL)).context,
                         angular=True)
            for i in range(k - 1)]
        pipeline_bench(codec, batch)  # warm the extra clouds' shapes
        wall = min(pipeline_bench(codec, batch)[0] for _ in range(2))
        agg = k * N_POINTS / wall
        out["record"]["pipeline"] = {"clouds": k, "points_per_sec": round(agg, 1),
                                     "x_single_scan": round(agg / out["record"]["value"], 3)}
        print(f"# pipeline k={k}: {wall:.4f}s for {k} clouds -> {agg:.1f} pts/s", flush=True)
    print(f"# device={torch.cuda.get_device_name(device)} n_points={N_POINTS} "
          f"nodes={len(slices.occ_stream)} pre={t_pre:.3f}s (octree {res.octree_s:.3f}s) "
          f"enc={out['encode_s']:.4f}s dec={out['decode_s']:.4f}s bpp={out['bpp']:.4f} "
          f"total wall {time.time() - t_start:.1f}s", flush=True)
    print(json.dumps(out["record"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
