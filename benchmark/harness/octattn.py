"""The OctAttention cells' arithmetic: the H100's f32 peak and the closed-form
products of OctAttention, frozen here so that no change to the program
moves them.

Products count 2 per multiply-add over the matrix products of the plain
reference (reference/octattention.py): per layer the five token-wide
projections (key and value of both streams, the unknown stream's query),
the attention's scores and its two value products, and both streams'
FFN; then the unknown stream's two decoder layers and the position maps
of both streams' rows.  `window_products(..., causal=True)` counts each
real node's query against the nodes up to its own (its known stream) and
before it (its unknown stream), as the causal window needs; with
causal=False it counts what the reference's dense forward computes over
a window of m rows (every query against every row), which
tests/test_benchmark_octattn.py holds equal to torch's FlopCounterMode.
"""

from __future__ import annotations

import math

from benchmark.reference.octattention import token_width

# NVIDIA H100 SXM data sheet: FP32 on the CUDA cores (the configuration
# codes in f32 with TF32 off, so no tensor-core rate applies)
PEAK_F32_FLOPS = 67e12


def window_products(widths: dict, m: int, causal: bool = True) -> int:
    """Forward products of OctAttention on one window of m real nodes."""
    d, f, t = token_width(widths), widths["hidden_dimension"], widths["token_num"]
    k, p = widths["level_k"], widths["abs_pos_embed_dim"]
    # keys summed over the window's queries: scores and the known values
    # see rows 0..j, the unknown values rows 0..j-1 (its own slot is a
    # rank-1 update)
    keys_known = m * (m + 1) // 2 if causal else m * m
    keys_unknown = m * (m - 1) // 2 if causal else m * m
    per_layer = (5 * 2 * m * d * d + 2 * 2 * keys_known * d + 2 * keys_unknown * d
                 + 2 * (2 * m * d * f + 2 * m * f * d))
    return (widths["layer_num"] * per_layer + 2 * m * d * d + 2 * m * d * t
            + 2 * 2 * m * k * 3 * p)


def level_products(widths: dict, n: int, csz: int) -> int:
    """One coding direction's products over a level of n nodes, cut into
    chunks of csz consecutive nodes."""
    full, rem = divmod(n, csz)
    return full * window_products(widths, csz) + (window_products(widths, rem) if rem else 0)


def mfu_f32(products: float, seconds: float, chips: int = 1) -> float | None:
    """Products over seconds x the chips' f32 peak, in percent."""
    if not seconds or seconds <= 0 or not math.isfinite(seconds):
        return None
    return 100.0 * products / (seconds * chips * PEAK_F32_FLOPS)


def nested(flat: dict, collection: str = "params") -> dict:
    """{collection: nested scopes} of numpy leaves from {flax path: tensor}:
    the weights a flax `.npz` would hold, for the program's loader."""
    out = {}
    for path, t in flat.items():
        node = out.setdefault(collection, {})
        *scope, leaf = path.split("/")
        for s in scope:
            node = node.setdefault(s, {})
        node[leaf] = t.detach().cpu().numpy()
    return out
