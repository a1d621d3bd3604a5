"""The yardstick's arithmetic: the H100's peaks and the closed-form
products and bytes of EHEM, frozen here so that no change to the program
moves them.

Products count 2 per multiply-add over the matrix products of the plain
reference (reference/ehem.py) at a window of m real nodes: what the
inputs need, not padding.  The EdgeConvs take their Dense over the k
edges of every node and the multiscale heads their concatenated input,
as the published model computes them (the program's rewrites do less);
attention counts each real query against the keys of its window (at most
the window, at most the stage's real length).  tests/test_benchmark_counts
holds `window_products` equal to torch's FlopCounterMode on the reference.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core products, HBM3 bandwidth
PEAK_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def _mlp(rows, dims):
    return sum(2 * rows * a * b for a, b in zip(dims[:-1], dims[1:]))


def graph_widths(static_knn: bool) -> list:
    return [3] if static_knn else [3, 144, 192]


def stage_lengths(m: int, stages: int) -> list:
    out = [m]
    for _ in range(stages - 1):
        out.append((out[-1] + 1) // 2)
    return out


def swin_block(n: int, c: int, f: int, w: int, cross: bool) -> dict:
    """Products of one block's attention and MLP sublayers on n real tokens."""
    proj_in = 2 * n * c * c + 2 * n * c * 2 * c if cross else 2 * n * c * 3 * c
    return {"attn": proj_in + 4 * n * min(w, n) * c + 2 * n * c * c,
            "mlp": 4 * n * c * f}


def window_products(widths: dict, static_knn: bool, m: int) -> dict:
    """Forward products of EHEM on one context window of m real nodes (both
    groups: phase 1 and phase 2), by part."""
    c, w = widths["embed_dim"], widths["window_size"]
    f = int(widths["mlp_ratio"] * c)
    k = min(20, m)
    h = (m + 1) // 2
    out = {"knn": sum(2 * m * m * g for g in graph_widths(static_knn))}
    out["geo"] = (sum(2 * m * k * 2 * ci * fo for ci, fo in ((3, 64), (144, 128), (192, 256)))
                  + _mlp(m, [80, 80, 64, 64]) + _mlp(m, [64, 128, 128, 128])
                  + _mlp(m, [448, 256, 256, 256]) + _mlp(m, [512, 256, 256, 128]))
    for name, depths, n0, cross in (("swin_self", widths["self_depths"], m, False),
                                    ("swin_cross", widths["cross_depths"], h, True)):
        lengths = stage_lengths(n0, len(depths))
        p = 0
        for s, depth in enumerate(depths):
            blk = swin_block(lengths[s], c, f, w, cross)
            p += depth * (blk["attn"] + blk["mlp"])
            if s < len(depths) - 1:
                p += (2 if cross else 1) * 2 * lengths[s + 1] * 2 * c * c
        out[name] = p
    t = widths["token_num"]
    out["heads"] = (_mlp(m, [c * len(widths["self_depths"]), 1024, 512, 256])
                    + _mlp(h, [256, 256, 256, t]) + _mlp(h, [16, 16, 16, 16])
                    + _mlp(h, [256, 256, 240, 240])
                    + _mlp(h, [c * len(widths["cross_depths"]) + 256, 768, 512, t]))
    return out


def total(parts: dict) -> int:
    return sum(parts.values())


# ---- kernels: (products, bytes) of the work a kernel family is given ----------


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)


def swin_kernel_work(widths: dict, m: int, width: int) -> list:
    """[(products, bytes)] per sublayer launch-lane of kernels A (the LN +
    MLP + residual of every block), B (self attention sublayers) and C
    (cross) on one window of m real nodes coded in a window of `width`
    rows: B and C run where the stage's padded length tiles the attention
    window, A everywhere.  bf16 activations (2 bytes), f32 norms and
    biases; each input byte read once, each output byte written once."""
    c, w = widths["embed_dim"], widths["window_size"]
    f = int(widths["mlp_ratio"] * c)
    out = []
    for depths, n0, w0, cross in ((widths["self_depths"], m, width, False),
                                  (widths["cross_depths"], (m + 1) // 2, width // 2, True)):
        lengths = stage_lengths(n0, len(depths))
        padded = stage_lengths(w0, len(depths))
        for s, depth in enumerate(depths):
            n = lengths[s]
            blk = swin_block(n, c, f, w, cross)
            mlp_bytes = 2 * n * c * 2 + 2 * c * f * 2 + (f + 3 * c) * 4
            attn_bytes = ((3 if cross else 2) * n * c * 2 + 4 * c * c * 2
                          + (2 * w - 1) * widths["num_heads"] * 4 + 6 * c * 4)
            tiles = padded[s] >= w and padded[s] % w == 0
            for _ in range(depth):
                out.append((blk["mlp"], mlp_bytes))
                if tiles:
                    out.append((blk["attn"], attn_bytes))
    return out


def knn_kernel_work(static_knn: bool, m: int, width: int, k: int = 20,
                    min_rows: int = 2048) -> list:
    """[(products, bytes)] of kernel D's graphs on one window: the
    brute-force score products over the m real nodes and each input byte
    (bf16 features) read once, each index (int64) written once; graphs of
    windows narrower than `min_rows` rows are not D's."""
    if width < min_rows:
        return []
    return [(2 * m * m * g, m * g * 2 + m * k * 8) for g in graph_widths(static_knn)]


def mfu_share(products: float, seconds: float, chips: int = 1) -> float | None:
    """Products over seconds x the chips' bf16 peak, in percent."""
    if not seconds or seconds <= 0 or not math.isfinite(seconds):
        return None
    return 100.0 * products / (seconds * chips * PEAK_FLOPS)
