"""Plain PyTorch reference of the OctAttention entropy model, in float32.

Written from the published description (Fu et al., "OctAttention:
Octree-Based Large-Scale Contexts Model for Point Cloud Compression", AAAI
2022) as SCP uses it (https://github.com/luoao-kddi/SCP,
`configs/model/oct_attn.yaml`, mirrored in this repository): every node is
one token made of itself and its `level_k - 1` nearest ancestors, each
ancestor row embedding (occupancy, level, octant) and a linear map of its
position; a causal transformer over a window of `context_size` nodes of
one level predicts each node's 255-way occupancy.  It imports nothing of
the program under test: weights are a flat dict {flax path: tensor} read
from the checkpoint by `load_params`, and every layer is spelled out with
plain tensor ops over the whole window at once (no cache).

Departures from the paper that follow SCP's model and the coded stream:

  * the layers are dual-stream (as XLNet's two streams): a known stream
    whose tokens hold each node's own occupancy and an unknown stream whose
    tokens hold the unknown symbol (255) in its place.  Both attend with
    the unknown stream's query to the known stream's keys and values of
    the nodes up to the query's own (causal mask); the unknown stream's own
    slot is scored with its own key (q_u . k_u) in place of the known one,
    its weight taken from the diagonal and zeroed there, and the
    diagonal weight times the unknown stream's own value added (a rank-1
    update), so that a node's prediction never reads its own occupancy;
  * the attention has no output projection; each sublayer adds its input
    and normalizes after (post-norm), LayerNorm eps 1e-5, softmax in f32;
  * the logits come from the unknown stream: ReLU(dense0) then dense1;
  * tokens are scaled by sqrt(token width) and a sinusoidal position
    table of `context_size` rows is added to both streams;
  * a node's level is clipped to the trained depth (`level - max(0,
    self level - 12)`, then to [0, max_level]): the identity at the L12
    the configuration codes.

`precision="bf16"` is the control: every matrix product takes operands
rounded to bfloat16 (f32 accumulation), the step below the f32 that the
configuration states.  Matrix products run with TF32 off (`exact_f32`).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-5
LEVEL_CLIP_REF = 12
UNKNOWN = 255  # occupancy of a pad row and of the unknown stream's own slot


@contextlib.contextmanager
def exact_f32():
    """float32 matrix products without TF32, restoring the settings."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def token_width(widths: dict) -> int:
    return widths["level_k"] * (widths["occ_embed_dim"] + widths["level_embed_dim"]
                                + widths["octant_embed_dim"] + widths["abs_pos_embed_dim"])


def load_params(path: str, device) -> dict:
    """{scope path: f32 tensor} of a flax `.npz` checkpoint's params."""
    out = {}
    with np.load(path) as z:
        for key in z.files:
            coll, rest = key.split("/", 1)
            if coll == "params":
                out[rest] = torch.from_numpy(z[key].astype(np.float32)).to(device)
    return out


def param_shapes(widths: dict) -> dict:
    """{scope path: shape} of every parameter of the model of `widths`."""
    d, f, t = token_width(widths), widths["hidden_dimension"], widths["token_num"]
    shapes = {"occ_enc/embedding": (t + 1, widths["occ_embed_dim"]),
              "level_enc/embedding": (widths["max_octree_level"] + 1, widths["level_embed_dim"]),
              "octant_enc/embedding": (9, widths["octant_embed_dim"]),
              "abs_pos_enc/kernel": (3, widths["abs_pos_embed_dim"]),
              "abs_pos_enc/bias": (widths["abs_pos_embed_dim"],)}

    def dense(path, i, o):
        shapes[f"{path}/kernel"] = (i, o)
        shapes[f"{path}/bias"] = (o,)

    for li in range(widths["layer_num"]):
        p = f"layer_{li}"
        for name in ("key", "query", "value"):
            dense(f"{p}/attn/{name}", d, d)
        dense(f"{p}/ffn1", d, f)
        dense(f"{p}/ffn2", f, d)
        for norm in ("norm1", "norm2"):
            shapes[f"{p}/{norm}/scale"] = (d,)
            shapes[f"{p}/{norm}/bias"] = (d,)
    dense("decoder0", d, d)
    dense("decoder1", d, t)
    return shapes


def fresh_params(widths: dict, generator: torch.Generator, device) -> dict:
    """Random weights of the model of `widths` (kernels normal with std
    1/sqrt(fan_in), biases and tables small, norms 1/0), drawn on
    `generator`'s device in one call per leaf."""
    out = {}
    for path, shape in param_shapes(widths).items():
        scope, leaf = path.rsplit("/", 1)
        if leaf == "scale":
            t = torch.ones(shape, device=device)
        elif leaf == "bias" and scope.rsplit("/", 1)[-1] in ("norm1", "norm2"):
            t = torch.zeros(shape, device=device)
        else:
            std = 1.0 / math.sqrt(shape[0]) if leaf == "kernel" else 0.1
            t = torch.randn(shape, generator=generator, device=device) * std
        out[path] = t
    return out


def position_table(rows: int, width: int) -> torch.Tensor:
    """The sinusoidal table: sin at even, cos at odd columns, f32."""
    pos = torch.arange(rows, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, width, 2, dtype=torch.float32) * (-math.log(10000.0) / width))
    pe = torch.zeros(rows, width)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


class Reference:
    """OctAttention's forward over whole windows, from flat f32 weights."""

    def __init__(self, params: dict, widths: dict, precision: str = "f32"):
        if precision not in ("f32", "bf16"):
            raise ValueError(f"precision {precision!r}: f32 or bf16")
        self.p, self.w, self.precision = params, widths, precision
        self.d = token_width(widths)
        self.heads = widths["head_num"]
        dev = params["decoder1/bias"].device
        self.pe = position_table(widths["context_size"], self.d).to(dev)

    def mm(self, a, b):
        if self.precision == "bf16":
            a, b = bf16_round(a), bf16_round(b)
        return a @ b

    def dense(self, x, path):
        return self.mm(x, self.p[f"{path}/kernel"]) + self.p[f"{path}/bias"]

    def layer_norm(self, x, path):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + LN_EPS) * self.p[f"{path}/scale"] \
            + self.p[f"{path}/bias"]

    def tokens(self, data, pos, unknown: bool):
        """data (B, N, K, 3) int (occupancy 0..255, level, octant), pos (B,
        N, K, 3) f32 -> (B, N, D) tokens of the known or unknown stream."""
        data = data.long()
        occ = data[..., 0]
        if unknown:
            occ = torch.cat([occ[..., :-1], torch.full_like(occ[..., -1:], UNKNOWN)], -1)
        level = data[..., 1]
        level = (level - (level[..., -1:] - LEVEL_CLIP_REF).clamp(min=0)).clamp(
            0, self.w["max_octree_level"])
        parts = [self.p["occ_enc/embedding"][occ], self.p["level_enc/embedding"][level],
                 self.p["octant_enc/embedding"][data[..., 2]], self.dense(pos, "abs_pos_enc")]
        t = torch.cat(parts, -1)
        return t.reshape(*t.shape[:-2], self.d) * math.sqrt(self.d)

    def heads_of(self, x):
        b, n, _ = x.shape
        return x.reshape(b, n, self.heads, self.d // self.heads).transpose(1, 2)

    def merge(self, x):
        b, h, n, hd = x.shape
        return x.transpose(1, 2).reshape(b, n, h * hd)

    def layer(self, known, unknown, path):
        hd = self.d // self.heads
        k = self.heads_of(self.dense(known, f"{path}/attn/key"))
        v = self.heads_of(self.dense(known, f"{path}/attn/value"))
        q = self.heads_of(self.dense(unknown, f"{path}/attn/query"))
        k_u = self.heads_of(self.dense(unknown, f"{path}/attn/key"))
        v_u = self.heads_of(self.dense(unknown, f"{path}/attn/value"))
        n = known.shape[1]
        later = torch.triu(torch.ones(n, n, dtype=torch.bool, device=known.device), 1)
        eye = torch.eye(n, dtype=torch.bool, device=known.device)
        scores = self.mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
        attn = torch.softmax(scores.masked_fill(later, -math.inf), -1)
        out = self.mm(attn, v)
        own = (q * k_u).sum(-1) / math.sqrt(hd)  # (B, h, N): the unknown slot's score
        scores_u = torch.where(eye, own[..., None], scores).masked_fill(later, -math.inf)
        attn_u = torch.softmax(scores_u, -1)
        own_w = torch.diagonal(attn_u, dim1=-2, dim2=-1)
        out_u = self.mm(attn_u.masked_fill(eye, 0.0), v) + own_w[..., None] * v_u
        known = self.layer_norm(known + self.merge(out), f"{path}/norm1")
        unknown = self.layer_norm(unknown + self.merge(out_u), f"{path}/norm1")
        return (self.layer_norm(known + self.ffn(known, path), f"{path}/norm2"),
                self.layer_norm(unknown + self.ffn(unknown, path), f"{path}/norm2"))

    def ffn(self, x, path):
        return self.dense(F.relu(self.dense(x, f"{path}/ffn1")), f"{path}/ffn2")

    def forward(self, data, pos):
        """Logits (B, N, 255) f32 of windows whose row j is the window's
        j-th node (N <= context_size)."""
        n = data.shape[1]
        known = self.tokens(data, pos, unknown=False) + self.pe[:n]
        unknown = self.tokens(data, pos, unknown=True) + self.pe[:n]
        for li in range(self.w["layer_num"]):
            known, unknown = self.layer(known, unknown, f"layer_{li}")
        return self.dense(F.relu(self.dense(unknown, "decoder0")), "decoder1")


def level_rows(tree, level_index: int):
    """(data (n, K, 3) int32 of (occupancy 0..254 or 255 missing, level,
    octant), pos (n, K, 3) f32, symbols (n,)) of one level's nodes, from
    reference/octree.py's `Octree.shard()` rows (four rows: three
    ancestors and the node); positions are cell origins over 2^max_level."""
    starts = np.concatenate([[0], np.cumsum(tree.sizes)])
    rows = tree.shard()[starts[level_index]:starts[level_index + 1]]
    data = np.stack([rows[:, :, 0] - 1, rows[:, :, 1], rows[:, :, 2]], -1).astype(np.int32)
    pos = (rows[:, :, 3:6].astype(np.float32) / np.float32(2 ** tree.max_level))
    return data, pos, (rows[:, -1, 0] - 1).astype(np.int64)


def sweep_windows(tree, csz: int):
    """Yield (level index, chunk, real rows m, data (csz, K, 3), pos (csz,
    K, 3), symbols (csz,) with 255 past m) of every context window of the
    sweep: each level cut into chunks of csz consecutive nodes, the last one
    padded with unknown rows (a causal window's real rows never read them)."""
    for li in range(len(tree.sizes)):
        data, pos, sym = level_rows(tree, li)
        n, k = data.shape[0], data.shape[1]
        for c in range(-(-n // csz)):
            m = min(csz, n - c * csz)
            d = np.zeros((csz, k, 3), np.int32)
            d[..., 0] = UNKNOWN
            d[:m] = data[c * csz:c * csz + m]
            p = np.zeros((csz, k, 3), np.float32)
            p[:m] = pos[c * csz:c * csz + m]
            y = np.full(csz, UNKNOWN, np.int64)
            y[:m] = sym[c * csz:c * csz + m]
            yield li, c, m, d, p, y
