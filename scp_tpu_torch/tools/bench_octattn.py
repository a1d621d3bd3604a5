"""OctAttention incremental codec benchmark of the port on the card (the twin
of scp_tpu/tools/bench_octattn.py).

    python -m scp_tpu_torch.tools.bench_octattn [n_points] [--device cpu]

Encodes and decodes the bench generator's sweep (seed 0, `n_points`,
default 30,000) at lidar level 12, spherical, with the incremental
(KV-cache) schedule on the host coder ("incr"): one step over every chunk
of a level per node position, one CDF-row fetch and one host-coder call
per position at decode.  The model is the full-width OctAttention (600-d
tokens, 3 layers, context 1024) in bf16, with flax-initialized weights
drawn from a seeded torch.Generator: the throughput does not depend on the
weights.  Prints the card's `nvidia-smi` name and power limit first, then
the encode wall and bits/node, the lossless decode wall and nodes/s, and
a second (steady) encode.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from scp_tpu_torch import ac, resolve_device
from scp_tpu_torch.codec.octattn_codec import OctAttentionCodec
from scp_tpu_torch.core.preprocess import kitti_qs, preprocess_points
from scp_tpu_torch.models.layers import flax_init_
from scp_tpu_torch.models.octattention import OctAttention
from scp_tpu_torch.tools.train_bench_ckpt import synth_kitti

LEVEL = 12


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("n_points", type=int, nargs="?", default=30_000)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default cuda; cpu runs the plain PyTorch path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip(), flush=True)

    pts = synth_kitti(np.random.default_rng(0), args.n_points)
    ctx = preprocess_points(pts, system="spher", qs=kitti_qs(LEVEL)).context
    n = ctx.shape[0]
    print(f"{args.n_points} pts -> {n} nodes at L{LEVEL}", flush=True)

    model = OctAttention(dtype=torch.bfloat16, device=device)  # 600-d token, context 1024
    flax_init_(model, torch.Generator().manual_seed(0))
    codec = OctAttentionCodec(model, mode="full")

    _sync(device)
    t0 = time.perf_counter()
    rows, syms, _ = codec.encode_incremental(ctx)
    enc = ac.StreamingEncoder()
    enc.append_quantized(rows, syms)
    stream, bits = enc.finish()
    t_enc = time.perf_counter() - t0
    print(f"warm+encode: {t_enc:.1f}s  bits/node={bits / n:.2f}", flush=True)

    _, occ_stream, max_level = codec.split_levels(ctx)
    dec = ac.ArithmeticDecoder(stream, occ_stream.shape[0])
    t0 = time.perf_counter()
    codes = codec.decode_incremental(dec, max_level, ground_truth=occ_stream)
    t_dec = time.perf_counter() - t0
    if not (codes == occ_stream).all():
        raise AssertionError("decode != encode symbols")
    print(f"DECODE OK: {t_dec:.1f}s for {n} nodes ({n / t_dec:.0f} nodes/s, "
          f"{args.n_points / (t_enc + t_dec):.0f} pts/s enc+dec)", flush=True)

    _sync(device)
    t0 = time.perf_counter()
    codec.encode_incremental(ctx)
    t_steady = time.perf_counter() - t0
    print(f"steady encode: {t_steady:.1f}s", flush=True)
    return dict(nodes=n, bits=bits, encode_s=t_enc, decode_s=t_dec, steady_encode_s=t_steady)


if __name__ == "__main__":
    main()
