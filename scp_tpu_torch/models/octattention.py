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

The full-window attention is plain PyTorch: scp_tpu computes it with
einsums and softmax, not with a Pallas kernel.  The KV-cache step's cached
attention is ops/cached_attn.py: on a CUDA model a hand-written kernel that
reads the cache length from device memory, on the CPU the step's batched
products as ever.  On a CUDA model decode_step and decode_insert replay
CUDA graphs captured per lane count at first use (StepGraphs): a replay
in place of one launch per operation.
"""

from __future__ import annotations

import functools
import math
import weakref

import torch
import torch.nn.functional as F
from torch import nn

from scp_tpu_torch import resolve_device
from scp_tpu_torch.models.layers import Dense, LayerNorm, sinusoidal_position_table
from scp_tpu_torch.ops import cached_attn
from scp_tpu_torch.utils import profiling
from scp_tpu_torch.utils.cuda_graphs import capture


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

    def _attend_cached(self, q, k_self, v_self, k_cache, v_cache, length):
        """q, k_self, v_self (lanes, D) against the first `length` cached rows
        of k_cache / v_cache (lanes, h, W, hd), plus the self slot.  `length`
        is a host int or an int64 device scalar (a captured step's)."""
        return cached_attn.cached_attention(q, k_self, v_self, k_cache, v_cache, length)

    def step_unknown(self, u, k_cache, v_cache, length):
        q = self.attn.query(u)
        out = self._attend_cached(q, self.attn.key(u), self.attn.value(u), k_cache, v_cache,
                                  length)
        h1 = self.norm1(u + out)
        return self.norm2(h1 + self._ffn(h1)).to(self.dtype), q

    def step_known(self, e, q, k_cache, v_cache, length):
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
        self._graphs: dict = {}  # lane count -> StepGraphs (CUDA models)
        self.step_replays = 0  # decode_step calls served by a graph replay
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

    def _position(self, x, length):
        if self.pos_embed:
            pe = (self.pe.index_select(0, length.view(1)) if isinstance(length, torch.Tensor)
                  else self.pe[length])
            x = x + pe.to(self.dtype)
        return x

    def _step(self, data_t, pos_t, cache, length):
        u = self._position(self._tokens(data_t, pos_t, unknown=True), length)
        qs = []
        for li, layer in enumerate(self.layers):
            u, q = layer.step_unknown(u, cache["k"][li], cache["v"][li], length)
            qs.append(q)
        return self.decoder1(F.relu(self.decoder0(u))), torch.stack(qs)

    def _insert(self, data_t, pos_t, cache, length, qs):
        lanes = data_t.shape[0]
        e = self._position(self._tokens(data_t, pos_t, unknown=False), length)
        last = len(self.layer_names) - 1
        for li, layer in enumerate(self.layers):
            kc, vc = cache["k"][li], cache["v"][li]
            if li == last:  # the known stream past the last layer feeds nothing
                k_e, v_e = layer.attn.key(e), layer.attn.value(e)
            else:
                e, k_e, v_e = layer.step_known(e, qs[li], kc, vc, length)
            k_e = k_e.view(lanes, self.num_heads, -1)
            v_e = v_e.view(lanes, self.num_heads, -1)
            if isinstance(length, torch.Tensor):
                kc.index_copy_(2, length.view(1), k_e[:, :, None])
                vc.index_copy_(2, length.view(1), v_e[:, :, None])
            else:
                kc[:, :, length] = k_e
                vc[:, :, length] = v_e
        return cache

    def step_graphs(self, lanes: int) -> "StepGraphs":
        """The captured step and insert of `lanes` lanes (CUDA models only),
        captured at first use."""
        g = self._graphs.get(lanes)
        if g is None:
            g = self._graphs[lanes] = StepGraphs(self, lanes)
        return g

    def _graphs_for(self, data_t, pos_t, cache):
        """The lane count's graphs, where the call is one they serve: a CUDA
        model, inputs (lanes, K, 3) of integer data and f32 positions on its
        device, and caches of init_cache's shape and dtype."""
        if self.device.type != "cuda":
            return None
        lanes = data_t.shape[0]
        k, v = cache["k"], cache["v"]
        want = (self.num_layers, lanes, self.num_heads, self.context_size,
                self.embed_dim // self.num_heads)
        if (tuple(data_t.shape) != (lanes, self.ancestors, 3) or pos_t.shape != data_t.shape
                or data_t.dtype not in (torch.int32, torch.int64)
                or pos_t.dtype != torch.float32 or data_t.device != self.device
                or pos_t.device != self.device or tuple(k.shape) != want
                or tuple(v.shape) != want or k.dtype != self.dtype or v.dtype != self.dtype
                or k.device != self.device or v.device != self.device):
            return None
        return self.step_graphs(lanes)

    def _apply(self, fn, *args, **kwargs):
        self._graphs = {}  # moved or recast weights: the graphs read the old ones
        return super()._apply(fn, *args, **kwargs)

    @torch.no_grad()
    def decode_step(self, data_t, pos_t, cache, length: int):
        """Predict window position `length` of every lane.

        data_t (lanes, K, 3) with the own occupancy arbitrary (masked),
        pos_t (lanes, K, 3).  Returns (logits (lanes, 255) f32,
        qs (layers, lanes, D)); qs feeds decode_insert.  On a CUDA model the
        step is a replay of the lane count's graph, and the returned tensors
        are the caller's own."""
        g = self._graphs_for(data_t, pos_t, cache)
        if g is None:
            return self._step(data_t, pos_t, cache, length)
        g.feed(data_t, pos_t, cache, length)
        g.replay_step()
        self.step_replays += 1
        return g.logits.clone(), g.returned(g.qs.clone())

    @torch.no_grad()
    def decode_insert(self, data_t, pos_t, cache, length: int, qs):
        """Write position `length` (its occupancy now known) into the
        caches, in place; returns `cache`."""
        g = self._graphs_for(data_t, pos_t, cache)
        if g is None:
            return self._insert(data_t, pos_t, cache, length, qs)
        g.feed(data_t, pos_t, cache, length, qs)
        g.replay_insert()
        g.write_back(cache, length)
        return cache


class StepGraphs:
    """decode_step and decode_insert of one lane count, captured as CUDA
    graphs over static buffers: the inputs, the position (an int64 device
    scalar the cached attention reads), the KV caches and the step's qs.

    A caller that steps in the static caches themselves (own_cache(), as
    the codec's level loop does) has its inserts land there directly.  For
    any other cache a call copies in what differs from the last: inputs
    that are other tensors, a position that changed, a cache that is not
    the one mirrored (another tensor, or one changed in place since: its
    version counter moved); after an insert the new cache row is written
    back to the caller's cache, so it stays the caller's in-place truth.
    qs passed back as decode_step returned it, unchanged, is already in
    place."""

    def __init__(self, model: OctAttention, lanes: int):
        dev = model.device
        with torch.cuda.device(dev):
            shape = (lanes, model.ancestors, 3)
            self.data = torch.zeros(shape, dtype=torch.int32, device=dev)
            self.pos = torch.zeros(shape, dtype=torch.float32, device=dev)
            self.length = torch.zeros((), dtype=torch.int64, device=dev)
            self.length_value = 0
            self.cache = model.init_cache(lanes)
            self.mirror = None  # (weakref of the caller's k, v, their versions)
            self.last_qs = None  # (the qs decode_step returned, its version)
            calls = cached_attn.cached_attention.captured
            self.step, (self.logits, self.qs) = capture(
                lambda: model._step(self.data, self.pos, self.cache, self.length))
            self.step_calls = cached_attn.cached_attention.captured - calls
            calls = cached_attn.cached_attention.captured
            self.insert, _ = capture(
                lambda: model._insert(self.data, self.pos, self.cache, self.length, self.qs))
            self.insert_calls = cached_attn.cached_attention.captured - calls
        profiling.count("octattn.graph_captures", 2)

    def own_cache(self) -> dict:
        """The static caches, zeroed as init_cache's, for a caller that
        steps in them: its inserts land in them with no copy either way."""
        self.cache["k"].zero_()
        self.cache["v"].zero_()
        self.mirror = None  # they no longer mirror another caller's cache
        return dict(self.cache)

    def replay_step(self) -> None:
        self.step.replay()
        cached_attn.replayed(self.step_calls)

    def replay_insert(self) -> None:
        self.insert.replay()
        cached_attn.replayed(self.insert_calls)

    def returned(self, qs):
        self.last_qs = (qs, qs._version)
        return qs

    def _is_static(self, cache) -> bool:
        return cache["k"] is self.cache["k"] and cache["v"] is self.cache["v"]

    def feed(self, data_t, pos_t, cache, length: int, qs=None) -> None:
        if data_t is not self.data:
            self.data.copy_(data_t)
        if pos_t is not self.pos:
            self.pos.copy_(pos_t)
        if length != self.length_value:
            self.length.fill_(length)
            self.length_value = length
        k, v = cache["k"], cache["v"]
        m = self.mirror
        if not self._is_static(cache) and (
                m is None or m[0]() is not k or m[1]() is not v
                or m[2] != (k._version, v._version)):
            self.cache["k"].copy_(k)
            self.cache["v"].copy_(v)
            self.mirror = (weakref.ref(k), weakref.ref(v), (k._version, v._version))
        if qs is not None and not (self.last_qs is not None and qs is self.last_qs[0]
                                   and qs._version == self.last_qs[1]):
            self.qs.copy_(qs)

    def write_back(self, cache, length: int) -> None:
        if self._is_static(cache):
            return
        k, v = cache["k"], cache["v"]
        k[:, :, :, length] = self.cache["k"][:, :, :, length]
        v[:, :, :, length] = self.cache["v"][:, :, :, length]
        self.mirror = (weakref.ref(k), weakref.ref(v), (k._version, v._version))
