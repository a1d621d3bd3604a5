"""Fused KNN distance + top-k (kernel D).

`knn_topk` is the port's counterpart of scp_tpu/ops/pallas_knn.py::
knn_pallas (Pallas kernel `_knn_kernel`, pallas_call in `_knn_single`):
feats (B, N, C), bf16 or f32, read as f32 -> (B, N, k) int64 indices of
the k largest scores 2 q.k - |q|^2 - |k|^2, in descending order, ties to
the lowest column (the first-max rule of pallas_knn._argmax_cols).  It
takes what the Pallas kernel takes: k <= 64 (a 2k <= 128-lane buffer
there) and any C.

The rounding follows the Pallas kernel's as it runs compiled: the squared
norms are chains of fused multiply-adds over the columns in order, the
score ((2 dot - |q|^2) - |k|^2) is rounded at each step.
The norms matter: on quantized positions many distances tie exactly, and
a norm rounded otherwise (each product rounded, as scp_tpu's XLA path
computes it) turns those ties into near ties that break the other way.

Dispatch is by the tensor's device: a CPU tensor runs the plain version
(`knn_topk_plain`: f32 score rows in 1024-row query tiles, then the
(score, index) top-k of ops/knn.py); a CUDA tensor launches the kernel of
csrc/knn_topk.cu or raises.

The wide arm (C > 4, or k > 32) scores bf16 features on the tensor cores
(f32 features on the CUDA cores) only to filter, in two passes: the first
keeps each query's top k by that score, whose k-th less a bound on the
score's error lies below the exact k-th; the second scores exactly (the
products summed in f64, exact for bf16 features, the dot rounded once to
f32) only the keys whose filter score plus the bound reaches it.  So its lists do
not depend on any summation order, and the plain version computes the
same scores (the dot products in f64, rounded once) and gives the same
lists, exact ties included.  Its rows are read in 16-byte chunks, so
features whose row is not a multiple of 16 bytes are padded with zero
columns first (zero products: the scores do not move).

Positions (C <= 4, k <= 32) take the kernel's pruned arm: rows in 32-row groups,
each with its bounding box; a warp of 8 queries scores its own group
first, then the others outward, and skips a group when no key in it can
reach any of its 8 lists.  `group_boxes`, `group_score_bound` and
`visit_order` are that arm's pre-pass, skip bound and visit order in
plain PyTorch and numpy, for the CPU tests (tests/test_torch_knn_prune.py);
nothing on the card's path calls them.
"""

from __future__ import annotations

import numpy as np
import torch

from scp_tpu_torch.ops import _cuda
from scp_tpu_torch.ops.knn import chunked_knn

MAX_K = 64  # a warp holds a query's running top-k, two slots per lane past 32
PRUNED_MAX_C = 4  # widths up to this take the pruned arm (positions) ...
PRUNED_MAX_K = 32  # ... at k up to this (one slot per lane); the rest the wide arm
GROUP = 32  # key rows per group (one per lane)
QPW = 8  # queries per warp
# the skip bound's margin: 2^-19 (|q| + |k|max)^2 + FLT_MIN, the constants
# of csrc/knn_topk.cu (derived there)
MARGIN_REL = 2.0 ** -19
MARGIN_ABS = 2.0 ** -126


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


def _fma_chain(a: torch.Tensor, b: torch.Tensor, acc: torch.Tensor | None) -> torch.Tensor:
    """fma(a, b, acc) in f32 (acc None: the product alone), emulated in f64
    as fma_sqnorm does."""
    p = a.double() * b.double()
    return (p if acc is None else p + acc.double()).float()


def group_boxes(feats: torch.Tensor):
    """The pruned arm's pre-pass: (B, N, C) -> per 32-row group (G =
    ceil(N / 32)) the f32 box lo (B, G, C), hi (B, G, C) and the largest
    |k|^2 (B, G, fma_sqnorm's rounding).  Rows >= N are not keys and stay
    out of the boxes."""
    b, n, c = feats.shape
    g = -(-n // GROUP)
    pad = g * GROUP - n
    x = feats.float()
    lo = torch.nn.functional.pad(x, (0, 0, 0, pad), value=float("inf"))
    hi = torch.nn.functional.pad(x, (0, 0, 0, pad), value=float("-inf"))
    ksq = torch.nn.functional.pad(fma_sqnorm(feats), (0, pad), value=0.0)
    return (lo.reshape(b, g, GROUP, c).amin(2), hi.reshape(b, g, GROUP, c).amax(2),
            ksq.reshape(b, g, GROUP).amax(2))


def group_score_bound(q: torch.Tensor, box_lo: torch.Tensor, box_hi: torch.Tensor,
                      ksq_max: torch.Tensor) -> torch.Tensor:
    """Upper bound on the f32 score any key of a group can reach for query
    q, in the kernel's f32 arithmetic: margin - gap^2, where gap^2 is the
    fma chain over the coordinates of max(lo - q, q - hi, 0) and margin =
    2^-19 (sqrt|q|^2 + sqrt ksq_max)^2 + 2^-126.  q (..., C) broadcasts
    against box_lo, box_hi (..., C) and ksq_max (...)."""
    q = q.float()
    d = torch.clamp(torch.maximum(box_lo - q, q - box_hi), min=0.0)
    gap = _fma_chain(d[..., 0], d[..., 0], None)
    for c in range(1, d.shape[-1]):
        gap = _fma_chain(d[..., c], d[..., c], gap)
    s = torch.sqrt(fma_sqnorm(q)) + torch.sqrt(ksq_max)
    m = (s * s) * torch.tensor(MARGIN_REL, dtype=torch.float32) + torch.tensor(
        MARGIN_ABS, dtype=torch.float32)
    return m - gap


def visit_order(g0: int, n_groups: int) -> np.ndarray:
    """The groups in the order a warp whose first query lies in group g0
    visits them: g0, then g0+1, g0-1, g0+2, ... clipped to [0, n_groups),
    each group once."""
    left, right = g0, n_groups - 1 - g0
    m = min(left, right)
    t = np.arange(1, n_groups)
    d = (t + 1) // 2
    near = np.where(t % 2 == 1, g0 + d, g0 - d)
    far = g0 + np.sign(right - left) * (t - m)
    return np.concatenate([[g0], np.where(t <= 2 * m, near, far)])


def takes_pruned_arm(c: int, k: int) -> bool:
    """Whether the kernel builds a (B, N, c) graph of k neighbors on its
    pruned arm (else its wide arm)."""
    return c <= PRUNED_MAX_C and k <= PRUNED_MAX_K


def knn_topk_plain(feats: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version: f32 scores (never rounded to bf16), exact top-k.  The
    dot products as each arm of the kernel rounds them: the library's f32
    product on positions (the pruned arm's fma chain agrees with it there),
    the exact dot rounded once to f32 elsewhere (the wide arm's)."""
    return chunked_knn(feats, k, fma_sqnorm(feats), round_bf16=False,
                       exact_dot=not takes_pruned_arm(feats.shape[-1], k))


def knn_topk(feats: torch.Tensor, k: int, stats: torch.Tensor | None = None) -> torch.Tensor:
    """feats (B, N, C) -> (B, N, k) int64 nearest-neighbor indices.

    `stats`, an int64 tensor of one element on the features' device: the
    pruned arm (C <= 4, k <= 32) adds to it the number of (warp, group)
    pairs it scored, out of B * ceil(N / 8) * ceil(N / 32).  The indices
    never depend on it; the wide arm and the plain version leave it as it
    is.

    The output is integer and has no gradient (scp_tpu's kernel D has no
    VJP either): the features must not need one."""
    if feats.requires_grad and torch.is_grad_enabled():
        raise ValueError("knn_topk: the features need a gradient; pass them detached")
    if feats.device.type == "cpu":
        return knn_topk_plain(feats, k)
    if feats.ndim != 3:
        raise ValueError(f"knn_topk: expected (B, N, C) features, got {tuple(feats.shape)}")
    b, n, c = feats.shape
    if not 1 <= k <= min(MAX_K, n):
        raise ValueError(f"knn_topk kernel: k={k} outside 1..min({MAX_K}, N={n})")
    if feats.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"knn_topk kernel: expected bf16 or f32 features, got {feats.dtype}")
    _cuda.check_cuda_tensor("feats", feats, feats.dtype, (b, n, c))
    if stats is not None:
        _cuda.check_cuda_tensor("stats", stats, torch.int64, (1,))
        if stats.device != feats.device:
            raise ValueError(f"stats: on {stats.device}, features on {feats.device}")
    lib = _cuda.load("knn_topk.cu")
    dev = feats.device
    sq = table = boxes = None
    arm = "pruned" if takes_pruned_arm(c, k) else "wide"
    if arm == "pruned":
        # key rows (coordinates, |k|^2 in the last slot) padded to whole
        # groups, and per group the box with the largest |k|^2
        row = 4 if c < 4 else 8
        g = -(-n // GROUP)
        table = torch.empty((b, g * GROUP, row), dtype=torch.float32, device=dev)
        boxes = torch.empty((b, g, 2 * row), dtype=torch.float32, device=dev)
    else:
        pad = -c % (16 // feats.element_size())  # whole 16-byte chunks per row
        if pad:
            feats = torch.nn.functional.pad(feats, (0, pad))
            c += pad
        sq = torch.empty((b, n), dtype=torch.float32, device=dev)
    out = torch.empty((b, n, k), dtype=torch.int64, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with _cuda.on_device(feats, stats):
        code = lib.scp_knn_topk(
            feats.data_ptr(), int(feats.dtype == torch.bfloat16), ptr(sq), ptr(table),
            ptr(boxes), ptr(stats), out.data_ptr(), b, n, c, k, _cuda.stream_ptr(feats),
        )
    _cuda.check(lib, code, "knn_topk")
    knn_topk.launches += 1
    knn_topk.arms[arm] += 1
    return out


knn_topk.launches = 0
knn_topk.arms = {"pruned": 0, "wide": 0}
