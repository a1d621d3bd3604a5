"""K-nearest-neighbor ops for the EdgeConv graphs (port of
scp_tpu/ops/knn.py, exact path).

The JAX package uses approximate top-k on a TPU and exact top-k on the
CPU; the port is exact everywhere.  Exact top-k must also agree on ties:
`jax.lax.top_k` puts the lower index first, and so does
`pallas_knn._argmax_cols`.  `torch.topk` promises no order among equal
values, so the port sorts on the pair (score, index) instead: each f32
score maps to an order-preserving int32, and the int64 key
`ordered * 2^32 + (2^32 - 1 - index)` is unique per column, largest for
the best score and, among equal scores, for the lowest index.

`knn_indices(..., fused=True)` takes graphs of N >= 2048 rows to the
fused distance + top-k op of ops/knn_topk.py (kernel D, the counterpart
of scp_tpu/ops/pallas_knn.py), as scp_tpu does under SCP_PALLAS_KNN=1
(scp_tpu/ops/knn.py:47-55).  scp_tpu also asks for a non-CPU backend
there; the port's rule is the same on every device: the CPU runs D's
plain version, the card its kernel.
"""

from __future__ import annotations

import torch

_KNN_CHUNK = 1024
FUSED_MIN_N = 2048  # graphs this large go to the fused op when it is on


def _ordered_key(scores: torch.Tensor) -> torch.Tensor:
    """(…, M) f32 scores -> (…, M) int64 keys, descending order of the key
    = descending score, ties broken to the lowest column index."""
    s = scores.float() + 0.0  # -0.0 -> +0.0 so both zeros tie
    b = s.view(torch.int32)
    ordered = b ^ ((b >> 31) & 0x7FFFFFFF)  # monotone f32 -> i32
    m = s.shape[-1]
    col = torch.arange(m, device=s.device, dtype=torch.int64)
    return ordered.to(torch.int64) * (1 << 32) + ((1 << 32) - 1 - col)


def top_k_lowest_ties(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores along the last axis, sorted by
    descending score with ties to the lowest index (lax.top_k's order)."""
    return torch.topk(_ordered_key(scores), k, dim=-1, sorted=True).indices


def _scores(q: torch.Tensor, q_sq: torch.Tensor, feats: torch.Tensor,
            sq: torch.Tensor, round_bf16: bool, exact_dot: bool = False) -> torch.Tensor:
    """2 q.k - |q|^2 - |k|^2 with f32 accumulation; `round_bf16` stores
    the scores in bf16 (scp_tpu's _score_dtype for bf16 features).
    `exact_dot` sums the dot products in f64 (exact for bf16 features)
    and rounds each once to f32 instead."""
    if exact_dot:
        s = 2.0 * torch.einsum("bqc,bmc->bqm", q.double(), feats.double()).float()
    else:
        s = 2.0 * torch.einsum("bqc,bmc->bqm", q.float(), feats.float())
    s = s - q_sq[:, :, None] - sq[:, None, :]
    if round_bf16:
        s = s.to(torch.bfloat16).float()
    return s


def chunked_knn(feats: torch.Tensor, k: int, sq: torch.Tensor,
                round_bf16: bool, exact_dot: bool = False) -> torch.Tensor:
    """Exact top-k over score rows built in query tiles of 1024 rows,
    which bound the (B, tile, N) score matrix; sq (B, N) are the f32
    squared norms."""
    n = feats.shape[1]
    out = []
    for s0 in range(0, n, _KNN_CHUNK):
        q = feats[:, s0 : s0 + _KNN_CHUNK]
        s = _scores(q, sq[:, s0 : s0 + _KNN_CHUNK], feats, sq, round_bf16, exact_dot)
        out.append(top_k_lowest_ties(s, k))
    return torch.cat(out, dim=1) if len(out) > 1 else out[0]


def knn_indices(feats: torch.Tensor, k: int, fused: bool = False,
                plain: bool = False) -> torch.Tensor:
    """k nearest neighbors (squared L2, self included).

    feats (B, N, C) -> (B, N, k) int64 indices.  With `fused`, graphs of
    N >= FUSED_MIN_N rows take kernel D (f32 scores; with `plain`, D's
    plain version on any device); the rest keep the chunked path, whose
    bf16 features keep bf16 scores."""
    if fused and feats.shape[1] >= FUSED_MIN_N:
        from scp_tpu_torch.ops import knn_topk  # imports this module

        return (knn_topk.knn_topk_plain if plain else knn_topk.knn_topk)(feats, k)
    sq = torch.sum(feats.float() * feats.float(), dim=-1)  # (B, N)
    return chunked_knn(feats, k, sq, feats.dtype == torch.bfloat16)


def gather_neighbors(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats (B, N, C), idx (B, N, k) -> (B, N, k, C) via one flat row
    gather over a (B*N, C) table."""
    b, n, c = feats.shape
    flat = feats.reshape(b * n, c)
    base = (torch.arange(b, device=idx.device, dtype=idx.dtype) * n)[:, None, None]
    out = flat[(idx + base).reshape(-1)]
    return out.reshape(b, idx.shape[1], idx.shape[2], c)


def max_over_neighbors(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats (B, N, C), idx (B, N, k) -> (B, N, C): max over the k
    gathered neighbor rows, one (B, N, C) gather per neighbor slot (the
    k-major order of scp_tpu; max has no rounding, so any order is exact)."""
    b, n, c = feats.shape
    flat = feats.reshape(b * n, c)
    base = (torch.arange(b, device=idx.device, dtype=idx.dtype) * n)[:, None]
    out = None
    for j in range(idx.shape[2]):
        g = flat[(idx[:, :, j] + base).reshape(-1)].reshape(b, idx.shape[1], c)
        out = g if out is None else torch.maximum(out, g)
    return out
