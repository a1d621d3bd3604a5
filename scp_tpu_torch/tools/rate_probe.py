"""Where the port's rate comes from: bits of the L16 bench cloud under
numerics variants of the same model, on the card.

    python3 -m scp_tpu_torch.tools.rate_probe

Encodes chip_smoke.py's cloud (120,000 points, seed 0, lidar level 16)
with the full-width EHEM from checkpoints/ehem_synth_f16_sknn.npz and
static KNN, once per variant, and prints bits per point:

  bf16         the main path (bf16 model, the CUDA kernels);
  bf16-knn32   as bf16, with the KNN scores kept in f32 instead of bf16;
  f32-plain    an f32 model whose Swin sublayers run their plain PyTorch
               versions on the card: the f32 reference that chip_smoke.py's
               phase 6 (the same model through the f32 kernels) is held to.

The variants patch module attributes for the length of one encode; this
is a probe of the rate, not a path of the codec.
"""

from __future__ import annotations

import os
import sys
from contextlib import contextmanager

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@contextmanager
def patched(pairs):
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in pairs]
    try:
        for obj, name, value in pairs:
            setattr(obj, name, value)
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


def main() -> int:
    if not torch.cuda.is_available():
        print("rate_probe measures the card; no CUDA device available")
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import CKPT, LIDAR_LEVEL, N_POINTS, synth_kitti
    from scp_tpu_torch.codec.ehem_codec import EHEMCodec
    from scp_tpu_torch.codec.slices import split_levels
    from scp_tpu_torch.core.preprocess import kitti_qs, preprocess_points
    from scp_tpu_torch.models import swin1d
    from scp_tpu_torch.models.ehem import EHEM
    from scp_tpu_torch.ops import knn, mlp, swin_attn
    from scp_tpu_torch.weights import load_into

    pts = synth_kitti(np.random.default_rng(0), N_POINTS)
    slices = split_levels(
        preprocess_points(pts, system="spher", qs=kitti_qs(LIDAR_LEVEL)).context, angular=True
    )

    def bits_of(dtype, patches):
        model = load_into(EHEM(static_knn=True, dtype=dtype, device="cuda"), CKPT)
        with patched(patches):
            _, bits, _ = EHEMCodec(model, context_size=8192).encode_to_stream(slices)
        return bits / N_POINTS

    scores = knn._scores

    def scores_f32(q, q_sq, feats, sq, round_bf16):
        return scores(q, q_sq, feats, sq, False)

    class PlainOps:  # the seams' plain versions, whatever the device
        ln_mlp_residual = staticmethod(mlp.ln_mlp_residual_plain)
        supported = staticmethod(mlp.supported)

    class PlainAttn:
        attn_sublayer_self = staticmethod(swin_attn.attn_sublayer_self_plain)
        attn_sublayer_cross = staticmethod(swin_attn.attn_sublayer_cross_plain)
        supported = staticmethod(swin_attn.supported)

    card = torch.cuda.get_device_name(0)
    rows = [
        ("bf16", bits_of(torch.bfloat16, [])),
        ("bf16-knn32", bits_of(torch.bfloat16, [(knn, "_scores", scores_f32)])),
        ("f32-plain", bits_of(torch.float32, [(swin1d, "mlp_ops", PlainOps),
                                              (swin1d, "swin_attn", PlainAttn)])),
    ]
    for name, bpp in rows:
        print(f"{card}: {name}: bpp {bpp:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
