"""Fast end-to-end self-test of the port: synthetic cloud -> encode ->
decode -> assert (the twin of scp_tpu/cli/selftest.py).

    python -m scp_tpu_torch.cli.selftest [--model ehem|octattn] [--device cpu]
        [--points N] [--system spher] [--ehem-mode rans|staged|full]

Runs on the card unless given `--device cpu`.  Exercises preprocessing,
the octree build, the codec (EHEM: device rANS, or the staged / full
modes on the native host coder under `--ehem-mode`, scp_tpu's
SCP_CODEC_MODE; OctAttention: the window schedule on the native host
coder) and the decode-time ground-truth assert, on a narrow model with
weights drawn from a seed.  Exit code 0 == lossless.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="ehem", choices=["ehem", "octattn"])
    ap.add_argument("--points", type=int, default=400)
    ap.add_argument("--system", default="spher", choices=["cart", "spher", "cylin"])
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default cuda; cpu runs the plain PyTorch path)")
    ap.add_argument("--ehem-mode", type=str, default=None, choices=["rans", "staged", "full"],
                    help="EHEM's coding mode (SCP_CODEC_MODE; default rans)")
    args = ap.parse_args(argv)
    if args.ehem_mode is not None and args.model != "ehem":
        ap.error("--ehem-mode is EHEM's coding mode")

    import numpy as np
    import torch

    from scp_tpu_torch import ac
    from scp_tpu_torch.codec.ehem_codec import EHEMCodec
    from scp_tpu_torch.codec.octattn_codec import OctAttentionCodec
    from scp_tpu_torch.codec.slices import split_levels
    from scp_tpu_torch.core.octree import deoctree
    from scp_tpu_torch.core.preprocess import preprocess_points
    from scp_tpu_torch.models.ehem import EHEM
    from scp_tpu_torch.models.layers import flax_init_
    from scp_tpu_torch.models.octattention import OctAttention

    rng = np.random.default_rng(7)
    n = args.points
    r = rng.uniform(2.0, 60.0, n)
    az = rng.uniform(0, 2 * np.pi, n)
    el = rng.uniform(-0.4, 0.2, n)
    pts = np.stack(
        [r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az), r * np.sin(el)], 1
    )

    res = preprocess_points(pts, system=args.system, qs=60.0 / 255)
    ctx = res.context
    print(f"cloud: {n} pts -> {ctx.shape[0]} octree nodes, system={args.system}")

    t0 = time.time()
    torch.manual_seed(0)
    if args.model == "ehem":
        model = EHEM(
            self_depths=(2, 2), cross_depths=(1,), embed_dim=64, num_heads=2,
            window_size=16, mlp_ratio=2.0, knn_k=4, device=args.device,
        )
        codec = EHEMCodec(model, context_size=64, mode=args.ehem_mode or "rans")
        angular = args.system != "cart"
        slices = split_levels(ctx, angular=angular)
        stream, bits, _ = codec.encode_to_stream(slices)
        dec = codec.new_stream_decoder(
            stream, codec.ac_symbols_per_node * slices.occ_stream.shape[0]
        )
        codes = codec.decode(
            dec, slices.max_level, np.array(slices.pos_mm, np.int64),
            angular=angular, ground_truth=slices.occ_stream,
            level_sizes=slices.level_sizes,
        )
        occ_stream = slices.occ_stream
    else:
        model = OctAttention(
            occ_embed_dim=16, level_embed_dim=4, octant_embed_dim=4,
            abs_pos_embed_dim=8, num_layers=2, num_heads=2, hidden_dim=64,
            context_size=32, device=args.device,
        )
        flax_init_(model, torch.Generator().manual_seed(0))
        codec = OctAttentionCodec(model)
        stream, bits, _ = codec.encode_to_stream(ctx)
        _, occ_stream, max_level = codec.split_levels(ctx)
        dec = ac.ArithmeticDecoder(stream, occ_stream.shape[0])
        codes = codec.decode(dec, max_level, ground_truth=occ_stream)

    if not (codes == occ_stream).all():
        raise AssertionError("decode != encode symbols")
    rec = res.grid.from_grid(deoctree(codes.astype(np.int64) + 1))
    if rec.shape != res.recon_points.shape:
        raise AssertionError(f"reconstruction {rec.shape} != {res.recon_points.shape}")
    print(
        f"LOSSLESS ROUNDTRIP OK  model={args.model}"
        f"{'' if args.model != 'ehem' else ' mode=' + codec.mode} device={model.device} "
        f"bpp={bits / n:.3f} bits/node={bits / len(occ_stream):.3f} "
        f"wall={time.time() - t0:.1f}s"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
