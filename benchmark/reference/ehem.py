"""Plain PyTorch reference of the EHEM entropy model, in float32.

Written from the published description (Song et al., CVPR 2023: a DGCNN
geometry trunk, a 1-D Swin encoder over the context window, a
checkerboard split into two groups, the second cross-attending to the
first's true occupancies) and the reference configuration
`configs/model/ehem.yaml`.  It imports nothing of the program under test:
weights are a flat dict {flax path: tensor} read from the checkpoint by
`load_params`, every layer is spelled out with plain tensor ops, and the
multiscale heads concatenate their upsampled inputs as the paper draws
them.  Departures that follow the coded stream rather than the paper:

  * KNN scores are squared distances in float64 (ties to the lower index);
  * training-mode BatchNorm normalizes with the batch statistics of the
    virtual (B, N, k, F) edge tensor, held out of the gradient (the
    program's declared stop-gradient; `edge_stats` takes them from outside
    so a batch can be processed in blocks of rows).

`precision="fp8"` is the control: every matrix product takes operands
rounded to float8 e4m3 (one scale per tensor), the step below the bf16 that
the configurations state.  Matrix products run with TF32 off.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-5
BN_EPS = 1e-5
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """float32 matrix products without TF32, restoring the settings."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def load_params(path: str, device) -> tuple[dict, dict]:
    """(params, batch_stats): flat {scope path: f32 tensor} dicts of a
    flax `.npz` checkpoint (fused q|k|v and k|v attention projections)."""
    params, stats = {}, {}
    with np.load(path) as z:
        for key in z.files:
            coll, rest = key.split("/", 1)
            t = torch.from_numpy(z[key].astype(np.float32)).to(device)
            (params if coll == "params" else stats)[rest] = t
    return params, stats


def param_shapes(widths: dict) -> dict:
    """{scope path: shape} of every parameter and statistic of the model of
    `widths` (the configuration file's keys), for fresh weights."""
    c, t, depth_s, depth_c = (widths["embed_dim"], widths["token_num"],
                              widths["self_depths"], widths["cross_depths"])
    w, heads, f = widths["window_size"], widths["num_heads"], int(widths["mlp_ratio"] * c)
    shapes = {}

    def dense(path, i, o, bias=True):
        shapes[f"params/{path}/kernel"] = (i, o)
        if bias:
            shapes[f"params/{path}/bias"] = (o,)

    def mlp(path, i, outs):
        for j, o in enumerate(outs):
            dense(f"{path}/dense_{j}", i, o)
            i = o

    def norm(path, d):
        shapes[f"params/{path}/scale"] = (d,)
        shapes[f"params/{path}/bias"] = (d,)

    shapes["params/geo/occ_enc/embedding"] = (256, 16)
    shapes["params/geo/level_enc/embedding"] = (widths["max_level"], 4)
    shapes["params/geo/octant_enc/embedding"] = (9, 4)
    for name, i, o in (("conv1", 3, 64), ("conv2", 144, 128), ("conv3", 192, 256)):
        dense(f"geo/{name}/conv", 2 * i, o, bias=False)
        norm(f"geo/{name}/bn", o)
        shapes[f"batch_stats/geo/{name}/bn/mean"] = (o,)
        shapes[f"batch_stats/geo/{name}/bn/var"] = (o,)
    mlp("geo/mlp2", 80, [80, 64, 64])
    mlp("geo/mlp3", 64, [128, 128, 128])
    mlp("geo/edge_mlp1", 448, [256, 256, 256])
    mlp("geo/edge_mlp2", 512, [256, 256, 128])
    for enc, depths in (("swin_self", depth_s), ("swin_cross", depth_c)):
        for s, depth in enumerate(depths):
            for b in range(depth):
                p = f"{enc}/stage_{s}/block_{b}"
                norm(f"{p}/norm1", c)
                norm(f"{p}/norm2", c)
                if enc == "swin_self":
                    dense(f"{p}/attn/qkv", c, 3 * c)
                else:
                    dense(f"{p}/attn/query", c, c)
                    dense(f"{p}/attn/kv", c, 2 * c)
                dense(f"{p}/attn/proj", c, c)
                shapes[f"params/{p}/attn/rel_pos_bias"] = (2 * w - 1, heads)
                dense(f"{p}/mlp1", c, f)
                dense(f"{p}/mlp2", f, c)
            if s < len(depths) - 1:
                norm(f"{enc}/stage_{s}/merge/norm", 2 * c)
                dense(f"{enc}/stage_{s}/merge/reduce", 2 * c, c, bias=False)
    mlp("ancient_mlp", c * len(depth_s), [1024, 512, 256])
    mlp("prob_pred_mlp1", 256, [256, 256, t])
    mlp("pre_occ_mlp", 16, [16, 16, 16])
    mlp("pre_attn_mlp", 256, [256, 240, 240])
    mlp("prob_pred_mlp2", c * len(depth_c) + 256, [768, 512, t])
    return shapes


def fresh_params(widths: dict, generator: torch.Generator, device) -> tuple[dict, dict]:
    """Random weights of the model of `widths` (kernels normal with std
    1/sqrt(fan_in), biases and tables small, norms 1/0, statistics 0/1),
    drawn on `generator`'s device in one call per leaf."""
    params, stats = {}, {}
    for path, shape in param_shapes(widths).items():
        coll, rest = path.split("/", 1)
        leaf = rest.rsplit("/", 1)[-1]
        if coll == "batch_stats":
            stats[rest] = (torch.zeros if leaf == "mean" else torch.ones)(shape, device=device)
            continue
        if leaf == "scale":
            t = torch.ones(shape, device=device)
        elif leaf == "bias" and rest.split("/")[-2] in ("norm1", "norm2", "norm", "bn"):
            t = torch.zeros(shape, device=device)
        else:
            std = 1.0 / math.sqrt(shape[0]) if leaf == "kernel" else 0.1
            t = torch.randn(shape, generator=generator, device=device) * std
        params[rest] = t
    return params, stats


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (amax -> 448);
    the gradient passes the rounding unchanged, as in fp8 training."""
    s = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return x + (q - x.detach())


class Reference:
    """EHEM forward (eval and train mode) over flat f32 weights."""

    def __init__(self, params: dict, stats: dict, widths: dict, static_knn: bool,
                 precision: str = "f32", knn_k: int = 20):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}: f32 or fp8")
        self.p, self.stats, self.widths = params, stats, widths
        self.static_knn = bool(static_knn)
        self.precision = precision
        self.k = knn_k
        self.heads = widths["num_heads"]
        self.window = widths["window_size"]
        self.train_mode = False
        self.edge_stats = None  # {conv name: (mean, var)} given from outside, train mode
        self.knn_cache = None  # {(address, shape): position graph}, set by a caller

    # ---- products --------------------------------------------------------

    def _op(self, t):
        return fp8_round(t) if self.precision == "fp8" else t

    def mm(self, x, w):
        return self._op(x) @ self._op(w)

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self._op(a), self._op(b))

    def dense(self, x, path, bias=True):
        y = self.mm(x, self.p[f"{path}/kernel"])
        return y + self.p[f"{path}/bias"] if bias else y

    def mlp(self, x, path, slope=0.01):
        n = sum(1 for k in self.p if k.startswith(f"{path}/dense_") and k.endswith("/kernel"))
        for i in range(n):
            x = self.dense(x, f"{path}/dense_{i}")
            if i < n - 1:
                x = F.leaky_relu(x, slope)
        return x

    def layer_norm(self, x, path):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + LN_EPS) * self.p[f"{path}/scale"] + self.p[f"{path}/bias"]

    # ---- geometry trunk --------------------------------------------------

    def knn(self, feats, k):
        """(B, N, C) -> (B, N, k) the set of nearest rows by squared
        distance (self included), exact in float64, ties to the lower
        index.  The set is what an EdgeConv reads (a max over it)."""
        f = feats.detach().double()
        out = []
        for b in range(f.shape[0]):
            x = f[b]
            sq = (x * x).sum(-1)
            d = sq[:, None] - 2.0 * (x @ x.T) + sq[None, :]
            thr = torch.kthvalue(d, k, dim=-1).values[:, None]
            lt, eq = d < thr, d == thr
            need = k - lt.sum(-1, keepdim=True)
            take = lt | (eq & (torch.cumsum(eq, -1) <= need))
            out.append(take.nonzero()[:, 1].reshape(x.shape[0], k))
            del d, lt, eq, take
        return torch.stack(out)

    def edge_conv(self, feats, idx, name):
        """max_k leaky(BN(cat(nb - c, c) W)), BatchNorm from the running
        statistics (eval) or the batch's (train)."""
        b, n, c = feats.shape
        nb = feats.reshape(b * n, c)[(idx + torch.arange(b, device=idx.device)[:, None, None] * n)
                                     .reshape(-1)].reshape(b, n, idx.shape[-1], c)
        ctr = feats[:, :, None, :].expand_as(nb)
        e = self.mm(torch.cat([nb - ctr, ctr], -1), self.p[f"geo/{name}/conv/kernel"])
        if self.train_mode:
            if self.edge_stats is not None and name in self.edge_stats:
                mean, var = self.edge_stats[name]
            else:
                e32 = e.detach()
                mean = e32.mean(dim=(0, 1, 2))
                var = ((e32 * e32).mean(dim=(0, 1, 2)) - mean * mean).clamp(min=0.0)
            self.last_stats[name] = (mean, var)
        else:
            mean, var = self.stats[f"geo/{name}/bn/mean"], self.stats[f"geo/{name}/bn/var"]
        h = (e - mean) / torch.sqrt(var + BN_EPS) * self.p[f"geo/{name}/bn/scale"] \
            + self.p[f"geo/{name}/bn/bias"]
        return F.leaky_relu(h, 0.2).amax(dim=2)

    def geo(self, data, pos):
        """data (B, N, 4, 3) ints (level, octant, occupancy), the node's own
        occupancy unused; pos (B, N, 3) -> (B, N, 256)."""
        self.last_stats = {}
        b, n = data.shape[:2]
        level, octant = data[..., 0].long(), data[..., 1].long()
        occ = data[:, :, :3, 2].long()
        x = torch.cat([self.p["geo/occ_enc/embedding"][occ].reshape(b, n, -1),
                       self.p["geo/level_enc/embedding"][level].reshape(b, n, -1),
                       self.p["geo/octant_enc/embedding"][octant].reshape(b, n, -1)], -1)
        k = min(self.k, n)
        key = (pos.data_ptr(), tuple(pos.shape))
        if self.knn_cache is not None and key in self.knn_cache:
            idx = self.knn_cache[key]
        else:
            idx = self.knn(pos, k)
            if self.knn_cache is not None:
                self.knn_cache[key] = idx
        pos1 = self.edge_conv(pos, idx, "conv1")
        f2 = torch.cat([pos1, x], -1)
        pos2 = self.edge_conv(f2, idx if self.static_knn else self.knn(f2, k), "conv2")
        x = self.mlp(x, "geo/mlp2")
        f3 = torch.cat([pos2, x], -1)
        pos3 = self.edge_conv(f3, idx if self.static_knn else self.knn(f3, k), "conv3")
        x = self.mlp(x, "geo/mlp3")
        ec = self.mlp(torch.cat([pos1, pos2, pos3], -1), "geo/edge_mlp1")
        ec = self.mlp(torch.cat([pos3, ec], -1), "geo/edge_mlp2")
        return torch.cat([x, ec], -1)

    # ---- 1-D Swin ----------------------------------------------------------

    def attention(self, xw, qw, path, mask):
        """Windows (B, nW, W, C) -> attended and projected (B, nW, W, C)."""
        bsz, nw, w, c = xw.shape
        h = self.heads
        hd = c // h
        if qw is None:
            q, k, v = torch.chunk(self.dense(xw, f"{path}/qkv"), 3, -1)
        else:
            q = self.dense(qw, f"{path}/query")
            k, v = torch.chunk(self.dense(xw, f"{path}/kv"), 2, -1)
        q, k, v = (t.reshape(bsz, nw, w, h, hd) for t in (q, k, v))
        s = self.einsum("bnqhd,bnkhd->bnhqk", q, k) / math.sqrt(hd)
        table = self.p[f"{path}/rel_pos_bias"]
        ar = torch.arange(w, device=xw.device)
        s = s + table[ar[:, None] - ar[None, :] + w - 1].permute(2, 0, 1)[None, None]
        if mask is not None:
            s = s + mask[None, :, None]
        a = torch.softmax(s, dim=-1)
        out = self.einsum("bnhqk,bnkhd->bnqhd", a, v).reshape(bsz, nw, w, c)
        return self.dense(out, f"{path}/proj")

    def shift_mask(self, length, shift, device):
        w = self.window
        zones = torch.zeros(length, device=device)
        zones[-w:-shift] = 1
        zones[-shift:] = 2
        zw = zones.reshape(-1, w)
        return torch.where(zw[:, :, None] != zw[:, None, :], -100.0, 0.0)

    def block(self, x, query, path, shift):
        b, n, c = x.shape
        w = self.window
        pad = (-n) % w
        length = n + pad
        shift = shift if length > w else 0

        def windows(t):
            t = F.pad(self.layer_norm(t, f"{path}/norm1"), (0, 0, 0, pad))
            if shift:
                t = torch.roll(t, -shift, dims=1)
            return t.reshape(b, length // w, w, c)

        mask = self.shift_mask(length, shift, x.device) if shift else None
        out = self.attention(windows(x), None if query is None else windows(query),
                             f"{path}/attn", mask).reshape(b, length, c)
        if shift:
            out = torch.roll(out, shift, dims=1)
        x = x + out[:, :n]
        hdn = F.gelu(self.dense(self.layer_norm(x, f"{path}/norm2"), f"{path}/mlp1"))
        return x + self.dense(hdn, f"{path}/mlp2")

    def merge(self, x, path):
        if x.shape[1] % 2:
            x = F.pad(x, (0, 0, 0, 1))
        x = torch.cat([x[:, 0::2], x[:, 1::2]], -1)
        return self.dense(self.layer_norm(x, f"{path}/norm"), f"{path}/reduce", bias=False)

    def encoder(self, x, name, depths, query=None):
        """Per-stage states before each merge (the multiscale pyramid)."""
        states = []
        for s, depth in enumerate(depths):
            for i in range(depth):
                x = self.block(x, query, f"{name}/stage_{s}/block_{i}",
                               0 if i % 2 == 0 else self.window // 2)
            states.append(x)
            if s < len(depths) - 1:
                x = self.merge(x, f"{name}/stage_{s}/merge")
                if query is not None:
                    query = self.merge(query, f"{name}/stage_{s}/merge")
        return states

    def multiscale(self, states, path, extra=None):
        n = states[0].shape[1]
        ups = [torch.repeat_interleave(s, 1 << i, dim=1)[:, :n] for i, s in enumerate(states)]
        return self.mlp(torch.cat(ups + ([extra] if extra is not None else []), -1), path)

    # ---- the two groups --------------------------------------------------

    def phase1(self, data, pos):
        """Group-1 (even rows) logits and both groups' trunk features."""
        feat = self.geo(data, pos)
        states = self.encoder(feat, "swin_self", self.widths["self_depths"])
        feat_a = self.multiscale(states, "ancient_mlp")
        f1, f2 = feat_a[:, 0::2], feat_a[:, 1::2]
        return self.mlp(f1, "prob_pred_mlp1"), f1, f2

    def phase2(self, f1, f2, occ1):
        """Group-2 (odd rows) logits given group 1's occupancies (255 = pad)."""
        key = torch.cat([self.mlp(self.p["geo/occ_enc/embedding"][occ1.long()], "pre_occ_mlp"),
                         self.mlp(f1, "pre_attn_mlp")], -1)
        states = self.encoder(key, "swin_cross", self.widths["cross_depths"], query=f2)
        return self.multiscale(states, "prob_pred_mlp2", extra=f2)

    def forward(self, data, pos):
        """Teacher-forced logits (B, N, 255), rows interleaved (even N)."""
        l1, f1, f2 = self.phase1(data, pos)
        l2 = self.phase2(f1, f2, data[:, 0::2, 3, 2])
        out = torch.stack([l1, l2], dim=2)
        return out.reshape(data.shape[0], data.shape[1], -1)
