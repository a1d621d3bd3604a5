"""Fused KNN distance + top-k (kernel D).

`knn_topk` is the port's counterpart of scp_tpu/ops/pallas_knn.py::
knn_pallas (Pallas kernel `_knn_kernel`, pallas_call in `_knn_single`):
feats (B, N, C), bf16 or f32, read as f32 -> (B, N, k) int64 indices of
the k largest scores 2 q.k - |q|^2 - |k|^2, in descending order, ties to
the lowest column (the first-max rule of pallas_knn._argmax_cols).

The rounding is the Pallas kernel's as it runs compiled: the dot product
and the squared norms are chains of fused multiply-adds over the columns
in order, the score ((2 dot - |q|^2) - |k|^2) is rounded at each step.
The norms matter: on quantized positions many distances tie exactly, and
a norm rounded otherwise (each product rounded, as scp_tpu's XLA path
computes it) turns those ties into near ties that break the other way.

Dispatch is by the tensor's device: a CPU tensor runs the plain version
(`knn_topk_plain`: f32 score rows in 1024-row query tiles, then the
(score, index) top-k of ops/knn.py); a CUDA tensor launches the kernel of
csrc/knn_topk.cu or raises.  The plain version's dot product is the
library's matrix product, whose summation order over wide rows may differ
from the kernel's, so near ties may swap on the card at C > 3.
"""

from __future__ import annotations

import torch

from scp_tpu_torch.ops import _cuda
from scp_tpu_torch.ops.knn import chunked_knn

MAX_K = 32  # one warp holds a query's running top-k, one slot per lane
MAX_C = 256


def fma_sqnorm(feats: torch.Tensor) -> torch.Tensor:
    """(B, N, C) -> (B, N) f32 |x|^2 as the chain t = fma(x_c, x_c, t) over
    c in order.  Each step is computed in f64, where the product is exact,
    and rounded to f32 (a double rounding that differs from one f32
    rounding only on exact f64 midpoints)."""
    x = feats.double()
    t = (x[..., 0] * x[..., 0]).float()
    for c in range(1, x.shape[-1]):
        t = (x[..., c] * x[..., c] + t.double()).float()
    return t


def knn_topk_plain(feats: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version: f32 scores (never rounded to bf16), exact top-k."""
    return chunked_knn(feats, k, fma_sqnorm(feats), round_bf16=False)


def knn_topk(feats: torch.Tensor, k: int) -> torch.Tensor:
    """feats (B, N, C) -> (B, N, k) int64 nearest-neighbor indices."""
    if feats.device.type == "cpu":
        return knn_topk_plain(feats, k)
    if feats.ndim != 3:
        raise ValueError(f"knn_topk: expected (B, N, C) features, got {tuple(feats.shape)}")
    b, n, c = feats.shape
    if not 1 <= k <= min(MAX_K, n):
        raise ValueError(f"knn_topk kernel: k={k} outside 1..min({MAX_K}, N={n})")
    if not 1 <= c <= MAX_C:
        raise ValueError(f"knn_topk kernel: C={c} outside 1..{MAX_C}")
    if feats.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"knn_topk kernel: expected bf16 or f32 features, got {feats.dtype}")
    _cuda.check_cuda_tensor("feats", feats, feats.dtype, (b, n, c))
    lib = _cuda.load("knn_topk.cu")
    sq = torch.empty((b, n), dtype=torch.float32, device=feats.device)
    out = torch.empty((b, n, k), dtype=torch.int64, device=feats.device)
    code = lib.scp_knn_topk(
        feats.data_ptr(), int(feats.dtype == torch.bfloat16), sq.data_ptr(), out.data_ptr(),
        b, n, c, k, _cuda.stream_ptr(feats),
    )
    _cuda.check(lib, code, "knn_topk")
    knn_topk.launches += 1
    return out


knn_topk.launches = 0
