"""DGCNN geometry feature extractor for EHEM, inference path (port of
scp_tpu/models/dgcnn.py).

Training (batch-statistics BatchNorm, the fused train EdgeConv) is not
ported yet; this module runs the folded inference BatchNorm only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from scp_tpu_torch.models.layers import MLP, Dense
from scp_tpu_torch.ops.knn import knn_indices, max_over_neighbors


class BatchNormInference(nn.Module):
    """flax BatchNorm's parameters and running statistics, read only."""

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


class EdgeConv(nn.Module):
    """1x1 conv + BatchNorm + LeakyReLU(0.2) + max over neighbors.

    The edge Dense is linear, so (nb - c, c) @ W = nb @ W1 + c @ (W2 - W1):
    the matmul runs before the gather.  BatchNorm is a per-channel affine
    and the center term is constant over the k neighbors, so BN folds in
    before the gather and the max comes before the affine:
      max_k leaky(BN(gather(a) + bc)) = leaky(max_k(gather(a*s)) + (bc*s + t))
    """

    def __init__(self, in_features: int, features: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = Dense(2 * in_features, features, bias=False, dtype=dtype)
        self.bn = BatchNormInference(features)

    def forward(self, feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        kern = self.conv.weight  # (F, 2C)
        c = feats.shape[-1]
        f = feats.to(self.dtype)
        a = F.linear(f, kern[:, :c])  # feats @ W1
        bc = F.linear(f, kern[:, c:] - kern[:, :c])  # feats @ (W2 - W1)
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
    SCP_PALLAS_KNN, an argument for the same reason)."""

    def __init__(self, k: int = 20, max_level: int = 19, static_knn: bool = False,
                 pallas_knn: bool = False, dtype=torch.float32):
        super().__init__()
        self.k = k
        self.static_knn = bool(static_knn)
        self.pallas_knn = bool(pallas_knn)
        self.dtype = dtype
        self.occ_enc = nn.Embedding(256, 16)
        self.level_enc = nn.Embedding(max_level, 4)
        self.octant_enc = nn.Embedding(9, 4)
        self.conv1 = EdgeConv(3, 64, dtype)
        self.conv2 = EdgeConv(64 + 80, 128, dtype)
        self.conv3 = EdgeConv(128 + 64, 256, dtype)
        self.mlp2 = MLP(80, [80, 64, 64], dtype=dtype)
        self.mlp3 = MLP(64, [128, 128, 128], dtype=dtype)
        self.edge_mlp1 = MLP(64 + 128 + 256, [256, 256, 256], dtype=dtype)
        self.edge_mlp2 = MLP(256 + 256, [256, 256, 128], dtype=dtype)

    def _lookup(self, emb: nn.Embedding, ids: torch.Tensor) -> torch.Tensor:
        """Row lookup of the table cast to the compute dtype — bit-exact
        with scp_tpu's one-hot matmul (dgcnn.py:144-159), which has one
        nonzero per row and so returns the table value itself."""
        return emb.weight.to(self.dtype)[ids.long()]

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
        fused = self.pallas_knn
        pos = pos.to(self.dtype)
        idx1 = knn_indices(pos, k, fused)
        pos1 = self.conv1(pos, idx1)
        f2 = torch.cat([pos1, x], -1)
        pos2 = self.conv2(f2, idx1 if self.static_knn else knn_indices(f2, k, fused))
        x = self.mlp2(x)
        f3 = torch.cat([pos2, x], -1)
        pos3 = self.conv3(f3, idx1 if self.static_knn else knn_indices(f3, k, fused))
        x = self.mlp3(x)

        ec = self.edge_mlp1(torch.cat([pos1, pos2, pos3], -1))
        ec = self.edge_mlp2(torch.cat([pos3, ec], -1))
        return torch.cat([x, ec], -1)  # (B, N, 256)

    def embed_occ(self, occ: torch.Tensor) -> torch.Tensor:
        return self._lookup(self.occ_enc, occ)
