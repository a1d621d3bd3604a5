"""OctAttention entropy model: the dual-stream causal transformer (port of
scp_tpu/models/octattention.py).

  * Each octree node token embeds (occupancy, level, octant, position) of
    itself and its 3 ancestors -> one 600-d token.
  * Dual stream: the prediction for node i must not see node i's own
    occupancy.  The unknown stream's attention diagonal is q_unk.k_unk,
    and its diagonal value v_unk.  The diagonal weight is zeroed BEFORE
    the value product (node i's own value contributes exactly 0.0) and a
    rank-1 update adds diag_w * v_unk, as scp_tpu computes it; a
    masked_fill of the same diagonal would change the bits.
  * Softmax and LayerNorm in f32, products in the module dtype, decoder1
    always f32.

Incremental decoding: `decode_step` predicts the node at window position
`length` from per-layer KV caches of the known stream, `decode_insert`
appends the decoded node to them.  scp_tpu vmaps both over a lane axis;
here they take the lanes as the leading axis.  The caches are one tensor
per K and V of shape (layers, lanes, heads, window, head_dim), written in
place (`decode_insert` returns the same dict), so a head's cached rows are
one strided matrix that the attention product reads without a copy.  The
step attends to the `length` cached rows only: the rows at or past
`length` carry an exact zero weight in scp_tpu's masked softmax, so the
result is the same function (the sum runs over fewer zeros).

Training drops at scp_tpu's sites (flax's nn.Dropout, inverted: a kept
element is scaled by 1 / (1 - p)): both streams' attention weights, both
attention outputs before the residual, the FFN hidden layer and the FFN
output.  The unknown stream's weights are dropped before the self-slot
weight is taken from their diagonal, as scp_tpu orders it.  The masks
come from the `torch.Generator` the caller passes to `forward`, never
from the global RNG; the trainer seeds one per step from (seed + 1, step),
as scp_tpu folds the step into PRNGKey(seed + 1), so a resumed run draws
the masks an uninterrupted run would have drawn.  The bits cannot match
JAX's RNG.  A data-parallel rank passes `drop_rows` = (its index, the
rank count): every site draws the mask of the global batch's shape and
keeps the rank's rows, so P ranks drop what one rank drops on the same
global batch (scp_tpu draws over its batch-sharded global array).  Eval
mode, p = 0, `decode_step` and `decode_insert` never
drop, so serving computes what it computed without dropout.

The attention is plain PyTorch: scp_tpu computes it with einsums and
softmax, not with a Pallas kernel, so this module launches no kernel of
its own.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from scp_tpu_torch import resolve_device
from scp_tpu_torch.models.layers import Dense, LayerNorm, sinusoidal_position_table


def _identity(x):
    return x


def dropout(x, p: float, generator: torch.Generator, rows: tuple = (0, 1)):
    """flax's nn.Dropout(p) in training: each element kept with
    probability 1 - p and divided by 1 - p, the rest 0; the mask drawn
    from `generator` (on x's device).  rows = (i, n): x is slice i of n
    equal slices of a global batch along dim 0; the mask is drawn for the
    global batch and slice i of it kept."""
    i, n = rows
    b = x.shape[0]
    keep = torch.rand((n * b, *x.shape[1:]), generator=generator, device=x.device)[
        i * b : (i + 1) * b] >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


class _QKV(nn.Module):
    """Shared W_k / W_q / W_v of both streams; no output projection."""

    def __init__(self, d_model: int, dtype: torch.dtype):
        super().__init__()
        self.key = Dense(d_model, d_model, dtype=dtype)
        self.query = Dense(d_model, d_model, dtype=dtype)
        self.value = Dense(d_model, d_model, dtype=dtype)


class DualStreamLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, hidden_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_model, self.num_heads, self.dtype = d_model, num_heads, dtype
        self.attn = _QKV(d_model, dtype)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.ffn1 = Dense(d_model, hidden_dim, dtype=dtype)
        self.ffn2 = Dense(hidden_dim, d_model, dtype=dtype)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    def _heads(self, x):
        """(b, n, D) -> (b, h, n, hd)."""
        b, n, _ = x.shape
        return x.view(b, n, self.num_heads, self.head_dim).transpose(1, 2)

    def _merge(self, x):
        b, h, n, hd = x.shape
        return x.transpose(1, 2).reshape(b, n, h * hd)

    def _ffn(self, x, drop=_identity):
        return self.ffn2(drop(F.relu(self.ffn1(x))))

    # -- full-window forward ---------------------------------------------------

    def forward(self, embed, embed_unknown, causal_mask, drop=_identity):
        """`drop` is the dropout of every site (the identity outside training)."""
        scale = math.sqrt(self.head_dim)
        k = self._heads(self.attn.key(embed))
        k_unk = self._heads(self.attn.key(embed_unknown))
        q_unk = self._heads(self.attn.query(embed_unknown))
        v = self._heads(self.attn.value(embed))
        v_unk = self._heads(self.attn.value(embed_unknown))

        scores = torch.matmul(q_unk, k.transpose(-1, -2)).float() / scale
        attn = drop(torch.softmax(scores + causal_mask, dim=-1))
        out = torch.matmul(attn.to(self.dtype), v)

        diag = torch.matmul(q_unk[..., None, :], k_unk[..., None])[..., 0, 0].float() / scale
        n = scores.shape[-1]
        eye = torch.eye(n, dtype=torch.float32, device=scores.device)
        scores_unk = scores * (1.0 - eye) + diag[..., None] * eye
        attn_unk = drop(torch.softmax(scores_unk + causal_mask, dim=-1)).to(self.dtype)
        diag_w = torch.diagonal(attn_unk, dim1=-2, dim2=-1)  # (b, h, n)
        attn_off = attn_unk * (1.0 - eye).to(self.dtype)
        out_unk = torch.matmul(attn_off, v) + diag_w[..., None] * v_unk

        embed = self.norm1(embed + drop(self._merge(out)))
        embed_unknown = self.norm1(embed_unknown + drop(self._merge(out_unk)))
        embed = self.norm2(embed + drop(self._ffn(embed, drop))).to(self.dtype)
        embed_unknown = self.norm2(
            embed_unknown + drop(self._ffn(embed_unknown, drop))).to(self.dtype)
        return embed, embed_unknown

    # -- one position over the lanes -------------------------------------------

    def _attend_cached(self, q, k_self, v_self, k_cache, v_cache, length: int):
        """q, k_self, v_self (lanes, D) against the first `length` cached rows
        of k_cache / v_cache (lanes, h, W, hd), plus the self slot."""
        lanes = q.shape[0]
        h, hd = self.num_heads, self.head_dim
        scale = math.sqrt(hd)
        qh = q.view(lanes * h, 1, hd)
        kh = k_cache[:, :, :length].reshape(lanes * h, length, hd)
        vh = v_cache[:, :, :length].reshape(lanes * h, length, hd)
        scores = torch.bmm(qh, kh.transpose(1, 2)).float() / scale  # (lanes*h, 1, length)
        diag = torch.bmm(qh, k_self.view(lanes * h, hd, 1)).float() / scale
        weights = torch.softmax(torch.cat([scores, diag], dim=-1), dim=-1).to(self.dtype)
        out = torch.bmm(weights[..., :length], vh)
        out = out + weights[..., length:] * v_self.view(lanes * h, 1, hd)
        return out.view(lanes, self.d_model)

    def step_unknown(self, u, k_cache, v_cache, length: int):
        q = self.attn.query(u)
        out = self._attend_cached(q, self.attn.key(u), self.attn.value(u), k_cache, v_cache,
                                  length)
        h1 = self.norm1(u + out)
        return self.norm2(h1 + self._ffn(h1)).to(self.dtype), q

    def step_known(self, e, q, k_cache, v_cache, length: int):
        """The known stream attends with the unknown stream's query `q`."""
        k_e, v_e = self.attn.key(e), self.attn.value(e)
        out = self._attend_cached(q, k_e, v_e, k_cache, v_cache, length)
        h1 = self.norm1(e + out)
        return self.norm2(h1 + self._ffn(h1)).to(self.dtype), k_e, v_e


class OctAttention(nn.Module):
    """(data, pos) -> 255-way logits per node.

    data: (B, N, K, 3) int, channels (occupancy 0..255, level, octant);
          occupancy 255 = pad / unknown.
    pos:  (B, N, K, 3) float normalized positions.
    """

    def __init__(
        self,
        token_num: int = 255,
        occ_embed_dim: int = 128,
        level_embed_dim: int = 6,
        octant_embed_dim: int = 4,
        abs_pos_embed_dim: int = 12,
        max_octree_level: int = 12,
        level_clip_ref: int = 12,
        num_layers: int = 3,
        num_heads: int = 4,
        hidden_dim: int = 300,
        context_size: int = 1024,
        ancestors: int = 4,
        pos_embed: bool = True,
        dropout: float = 0.0,
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        self.token_num = token_num
        self.max_octree_level = max_octree_level
        self.level_clip_ref = level_clip_ref
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.context_size = context_size
        self.ancestors = ancestors
        self.pos_embed = pos_embed
        self.abs_pos_embed_dim = abs_pos_embed_dim
        self.dropout = float(dropout)
        self.dtype = dtype
        self.embed_dim = ancestors * (
            occ_embed_dim + level_embed_dim + octant_embed_dim + abs_pos_embed_dim)
        self.occ_enc = nn.Embedding(token_num + 1, occ_embed_dim)
        self.level_enc = nn.Embedding(max_octree_level + 1, level_embed_dim)
        self.octant_enc = nn.Embedding(9, octant_embed_dim)
        if abs_pos_embed_dim:
            self.abs_pos_enc = Dense(3, abs_pos_embed_dim, dtype=dtype)
        self.layer_names = [f"layer_{i}" for i in range(num_layers)]
        for name in self.layer_names:
            self.add_module(name, DualStreamLayer(self.embed_dim, num_heads, hidden_dim, dtype))
        self.decoder0 = Dense(self.embed_dim, self.embed_dim, dtype=dtype)
        self.decoder1 = Dense(self.embed_dim, token_num, dtype=torch.float32)
        pe = torch.from_numpy(sinusoidal_position_table(context_size, self.embed_dim))
        self.register_buffer("pe", pe, persistent=False)
        self.eval()
        self.to(resolve_device(device))

    @staticmethod
    def from_config(cfg, dtype=torch.float32, device=None) -> "OctAttention":
        m = cfg["model"]
        return OctAttention(
            token_num=m["token_num"],
            occ_embed_dim=m["occ_embed_dim"],
            level_embed_dim=m["level_embed_dim"],
            octant_embed_dim=m["octant_embed_dim"],
            abs_pos_embed_dim=m["abs_pos_embed_dim"],
            max_octree_level=m["max_octree_level"],
            level_clip_ref=10 if cfg["train"]["type"] == "obj" else 12,
            num_layers=m["layer_num"],
            num_heads=m["head_num"],
            hidden_dim=m["hidden_dimension"],
            context_size=m["context_size"],
            ancestors=m["level_k"],
            pos_embed=bool(m["pos_embed"]),
            dropout=float(cfg["train"].get("dropout", 0.0)),
            dtype=dtype,
            device=device,
        )

    @property
    def device(self) -> torch.device:
        return self.decoder1.bias.device

    @property
    def layers(self):
        return [getattr(self, n) for n in self.layer_names]

    # -- embeddings ------------------------------------------------------------

    def _renorm_level(self, level):
        level = level - (level[..., -1:] - self.level_clip_ref).clamp(min=0)
        return level.clamp(0, self.max_octree_level)

    def _embed(self, table: nn.Embedding, idx):
        return F.embedding(idx, table.weight).to(self.dtype)

    def _tokens(self, data, pos, unknown: bool):
        """data (..., K, 3) int, pos (..., K, 3) -> tokens (..., D)."""
        data = data.to(torch.int64)
        occupancy = data[..., 0]
        if unknown:  # the node's own occupancy is replaced by the unknown token
            occupancy = occupancy.clone()
            occupancy[..., -1] = self.token_num
        parts = [self._embed(self.occ_enc, occupancy),
                 self._embed(self.level_enc, self._renorm_level(data[..., 1])),
                 self._embed(self.octant_enc, data[..., 2])]
        if self.abs_pos_embed_dim:
            parts.append(self.abs_pos_enc(pos.to(self.dtype)))
        t = torch.cat(parts, dim=-1)
        return t.reshape(*t.shape[:-2], self.embed_dim) * math.sqrt(self.embed_dim)

    # -- full forward ----------------------------------------------------------

    def _dropper(self, generator, rows):
        if not (self.training and self.dropout > 0.0):
            return _identity
        if generator is None:
            raise ValueError(f"OctAttention in train mode drops with p = {self.dropout}: pass "
                             "forward a torch.Generator on the model's device")
        return functools.partial(dropout, p=self.dropout, generator=generator, rows=rows)

    def forward(self, data, pos, generator: torch.Generator | None = None,
                drop_rows: tuple = (0, 1)):
        """Logits (B, N, 255) f32.  In train mode with dropout > 0 the
        masks are drawn from `generator`, for a global batch of which this
        batch is slice drop_rows = (index, count)."""
        drop = self._dropper(generator, drop_rows)
        n = data.shape[1]
        embed = self._tokens(data, pos, unknown=False)
        embed_unknown = self._tokens(data, pos, unknown=True)
        if self.pos_embed:
            pe = self.pe[:n].to(self.dtype)
            embed = embed + pe
            embed_unknown = embed_unknown + pe
        causal_mask = torch.triu(
            torch.full((n, n), float("-inf"), dtype=torch.float32, device=embed.device),
            diagonal=1)
        for layer in self.layers:
            embed, embed_unknown = layer(embed, embed_unknown, causal_mask, drop)
        return self.decoder1(F.relu(self.decoder0(embed_unknown)))

    # -- incremental decode ----------------------------------------------------

    def init_cache(self, lanes: int) -> dict:
        """Known-stream KV caches of `lanes` windows, zeroed:
        {"k", "v"} each (layers, lanes, heads, window, head_dim)."""
        shape = (self.num_layers, lanes, self.num_heads, self.context_size,
                 self.embed_dim // self.num_heads)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=self.dtype, device=self.device)}

    def _position(self, x, length: int):
        if self.pos_embed:
            x = x + self.pe[length].to(self.dtype)
        return x

    @torch.no_grad()
    def decode_step(self, data_t, pos_t, cache, length: int):
        """Predict window position `length` of every lane.

        data_t (lanes, K, 3) with the own occupancy arbitrary (masked),
        pos_t (lanes, K, 3).  Returns (logits (lanes, 255) f32,
        qs (layers, lanes, D)); qs feeds decode_insert."""
        u = self._position(self._tokens(data_t, pos_t, unknown=True), length)
        qs = []
        for li, layer in enumerate(self.layers):
            u, q = layer.step_unknown(u, cache["k"][li], cache["v"][li], length)
            qs.append(q)
        return self.decoder1(F.relu(self.decoder0(u))), torch.stack(qs)

    @torch.no_grad()
    def decode_insert(self, data_t, pos_t, cache, length: int, qs):
        """Write position `length` (its occupancy now known) into the
        caches, in place; returns `cache`."""
        lanes = data_t.shape[0]
        e = self._position(self._tokens(data_t, pos_t, unknown=False), length)
        for li, layer in enumerate(self.layers):
            kc, vc = cache["k"][li], cache["v"][li]
            e, k_e, v_e = layer.step_known(e, qs[li], kc, vc, length)
            kc[:, :, length] = k_e.view(lanes, self.num_heads, -1)
            vc[:, :, length] = v_e.view(lanes, self.num_heads, -1)
        return cache
