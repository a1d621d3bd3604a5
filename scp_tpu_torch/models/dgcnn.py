"""DGCNN geometry feature extractor for EHEM (port of
scp_tpu/models/dgcnn.py).

Evaluation (the codec) folds the running BatchNorm into the gather + max.
Training (`self.training`) normalizes with the batch statistics, in one
of scp_tpu's two arms: the fused arm (`fused_edgeconv=True`, scp_tpu's
default; ops/edgeconv_fused.py, stop-gradient through the statistics) or
the explicit arm (scp_tpu's SCP_FUSED_EDGECONV=0: the f32 (B, N, k, F)
edge tensor, BatchNorm with its full gradient).  The KNN graphs carry no
gradient (integer indices); they are built from detached features.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from scp_tpu_torch.models.layers import MLP, Dense
from scp_tpu_torch.ops.edgeconv_fused import edgeconv_train_fused
from scp_tpu_torch.ops.knn import gather_neighbors, knn_indices, max_over_neighbors
from scp_tpu_torch.train import distributed

BN_MOMENTUM = 0.9  # flax nn.BatchNorm(momentum=0.9): ra = 0.9 ra + (1 - 0.9) batch


def batch_stats(x32: torch.Tensor, dims, global_batch: bool = False):
    """flax's _compute_stats (use_fast_variance): mean and the biased
    variance E[x^2] - E[x]^2, clipped at 0, over `dims` of an f32 tensor.

    `global_batch`: the statistics of the data-parallel global batch, as
    scp_tpu's BatchNorm takes them over its batch-sharded array: E[x] and
    E[x^2] averaged over the ranks (every rank holds as many rows), with
    their gradient.  Nothing changes with one rank."""
    mu = x32.mean(dim=dims)
    mu2 = (x32 * x32).mean(dim=dims)
    n = distributed.world_size() if global_batch else 1
    if n > 1:
        mu = distributed.global_sum(mu, grad=True) / n
        mu2 = distributed.global_sum(mu2, grad=True) / n
    return mu, torch.clamp(mu2 - mu * mu, min=0.0)


class BatchNorm(nn.Module):
    """flax BatchNorm: parameters, running statistics, the inference fold
    and the training-mode update.  Not torch.nn.BatchNorm1d, whose running
    variance is unbiased and whose momentum means the other weight."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def folded(self):
        """(s, t) with BN(h) = h * s + t, in f32 (dgcnn.py:98-117)."""
        s = self.weight / torch.sqrt(self.running_var + self.eps)
        return s, self.bias - self.running_mean * s

    def normalize(self, x32, mean, var):
        """flax's _normalize: (x - mean) * (rsqrt(var + eps) * scale) + bias."""
        return (x32 - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias

    @torch.no_grad()
    def update(self, mean, var):
        """ra = 0.9 ra + (1 - 0.9) batch, for the mean and the biased variance."""
        w = 1 - BN_MOMENTUM
        self.running_mean.copy_(BN_MOMENTUM * self.running_mean + w * mean.detach())
        self.running_var.copy_(BN_MOMENTUM * self.running_var + w * var.detach())


class EdgeConv(nn.Module):
    """1x1 conv + BatchNorm + LeakyReLU(0.2) + max over neighbors.

    The edge Dense is linear, so (nb - c, c) @ W = nb @ W1 + c @ (W2 - W1):
    the matmul runs before the gather.  BatchNorm is a per-channel affine
    and the center term is constant over the k neighbors, so BN folds in
    before the gather and the max comes before the affine:
      max_k leaky(BN(gather(a) + bc)) = leaky(max_k(gather(a*s)) + (bc*s + t))
    """

    def __init__(self, in_features: int, features: int, dtype=torch.float32,
                 fused: bool = True, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.fused = bool(fused)
        self.remat = bool(remat)
        self.conv = Dense(2 * in_features, features, bias=False, dtype=dtype)
        self.bn = BatchNorm(features)

    def _project(self, feats):
        kern = self.conv.kernel()  # (F, 2C) in the compute dtype
        c = feats.shape[-1]
        f = feats.to(self.dtype)
        a = F.linear(f, kern[:, :c])  # feats @ W1
        bc = F.linear(f, kern[:, c:] - kern[:, :c])  # feats @ (W2 - W1)
        return a, bc

    def _train(self, feats, idx):
        """Training forward -> (out, batch mean, batch var)."""
        a, bc = self._project(feats)
        bn = self.bn
        if self.fused:
            out, mean, var = edgeconv_train_fused(a, bc, bn.weight, bn.bias, idx, bn.eps)
            # scp_tpu updates the running statistics with a 2-sample batch
            # whose (mean, biased var) are (mean, var): the same rounding here
            std = torch.sqrt(var)
            mean, var = batch_stats(torch.stack([mean + std, mean - std]), 0)
            return out.to(self.dtype), mean, var
        h = (gather_neighbors(a, idx) + bc[:, :, None, :]).float()  # (B, N, k, F)
        mean, var = batch_stats(h, (0, 1, 2), global_batch=True)
        h = F.leaky_relu(bn.normalize(h, mean, var), 0.2)
        return h.amax(dim=2).to(self.dtype), mean, var

    def forward(self, feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        if self.training:
            if self.remat and torch.is_grad_enabled():
                # the statistics leave the recomputed region, so the
                # backward's recompute cannot update them a second time
                out, mean, var = checkpoint(self._train, feats, idx, use_reentrant=False)
            else:
                out, mean, var = self._train(feats, idx)
            self.bn.update(mean, var)
            return out
        a, bc = self._project(feats)
        s, t = self.bn.folded()
        a = (a.float() * s).to(self.dtype)
        bc = (bc.float() * s + t).to(self.dtype)
        h = max_over_neighbors(a, idx) + bc
        return F.leaky_relu(h, 0.2)


class GeoFeatGenerator(nn.Module):
    """Per-node 256-d geometry features (reference GeoFeatGenerator,
    dgcnn.py:74-154): 3 EdgeConv rounds interleaved with per-node MLPs on
    the ancestor (occ, level, octant) embedding.

    `static_knn` reuses the position graph for all three EdgeConv rounds
    (scp_tpu reads it from SCP_STATIC_KNN; here it is an argument, so no
    string such as "0" can turn it on by accident).  `pallas_knn` sends
    graphs of N >= 2048 rows to the fused KNN op, kernel D (scp_tpu's
    SCP_PALLAS_KNN, an argument for the same reason); `plain_seams` sends
    those graphs to D's plain version on any device."""

    def __init__(self, k: int = 20, max_level: int = 19, static_knn: bool = False,
                 pallas_knn: bool = False, dtype=torch.float32, fused_edgeconv: bool = True,
                 remat: bool = False, plain_seams: bool = False):
        super().__init__()
        self.k = k
        self.plain_seams = bool(plain_seams)
        self.static_knn = bool(static_knn)
        self.pallas_knn = bool(pallas_knn)
        self.dtype = dtype
        self.occ_enc = nn.Embedding(256, 16)
        self.level_enc = nn.Embedding(max_level, 4)
        self.octant_enc = nn.Embedding(9, 4)
        self.conv1 = EdgeConv(3, 64, dtype, fused_edgeconv, remat)
        self.conv2 = EdgeConv(64 + 80, 128, dtype, fused_edgeconv, remat)
        self.conv3 = EdgeConv(128 + 64, 256, dtype, fused_edgeconv, remat)
        self.mlp2 = MLP(80, [80, 64, 64], dtype=dtype)
        self.mlp3 = MLP(64, [128, 128, 128], dtype=dtype)
        self.edge_mlp1 = MLP(64 + 128 + 256, [256, 256, 256], dtype=dtype)
        self.edge_mlp2 = MLP(256 + 256, [256, 256, 128], dtype=dtype)

    def _lookup(self, emb: nn.Embedding, ids: torch.Tensor) -> torch.Tensor:
        """Row lookup of the table cast to the compute dtype — bit-exact
        with scp_tpu's one-hot matmul (dgcnn.py:144-159), which has one
        nonzero per row and so returns the table value itself."""
        return emb.weight.to(self.dtype)[ids.long()]

    def _knn(self, feats, k):
        """The graph of `feats`: integer indices, no gradient (the index
        output of top-k has none in scp_tpu either)."""
        with torch.no_grad():
            return knn_indices(feats.detach(), k, self.pallas_knn, self.plain_seams)

    def forward(self, data: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """data (B, N, 11) int: 4x(level, octant, occ) minus the current
        occ; pos (B, N, 3) float normalized positions -> (B, N, 256)."""
        b, n = data.shape[:2]
        level = data[:, :, 0::3]
        octant = data[:, :, 1::3]
        occ = data[:, :, 2::3]
        x = torch.cat(
            [
                self._lookup(self.occ_enc, occ).reshape(b, n, -1),
                self._lookup(self.level_enc, level).reshape(b, n, -1),
                self._lookup(self.octant_enc, octant).reshape(b, n, -1),
            ],
            dim=-1,
        )  # (B, N, 80)

        k = min(self.k, n)
        pos = pos.to(self.dtype)
        idx1 = self._knn(pos, k)
        pos1 = self.conv1(pos, idx1)
        f2 = torch.cat([pos1, x], -1)
        pos2 = self.conv2(f2, idx1 if self.static_knn else self._knn(f2, k))
        x = self.mlp2(x)
        f3 = torch.cat([pos2, x], -1)
        pos3 = self.conv3(f3, idx1 if self.static_knn else self._knn(f3, k))
        x = self.mlp3(x)

        ec = self.edge_mlp1(torch.cat([pos1, pos2, pos3], -1))
        ec = self.edge_mlp2(torch.cat([pos3, ec], -1))
        return torch.cat([x, ec], -1)  # (B, N, 256)

    def graph_widths(self) -> list:
        """The feature width C of each KNN graph a forward builds: the
        positions', then (dynamic graph) EdgeConv 2's and 3's inputs."""
        if self.static_knn:
            return [3]
        return [3, self.conv2.conv.weight.shape[1] // 2, self.conv3.conv.weight.shape[1] // 2]

    def flops(self, batch: int, n: int) -> int:
        """Forward products on (batch, n) nodes, 2 per multiply-add: each
        KNN graph's scores (2 q.k) and the Dense layers (an EdgeConv's two
        projections are its 2C -> F Dense)."""
        rows = batch * n
        f = sum(2 * batch * n * n * c for c in self.graph_widths())
        f += sum(conv.conv.flops(rows) for conv in (self.conv1, self.conv2, self.conv3))
        return f + sum(m.flops(rows) for m in (self.mlp2, self.mlp3, self.edge_mlp1,
                                               self.edge_mlp2))

    def embed_occ(self, occ: torch.Tensor) -> torch.Tensor:
        return self._lookup(self.occ_enc, occ)
