"""Plain reference of EHEM's training steps, in float32 with TF32 off.

The loss is the mean over every node of the batch of -log2 p(label) (a pad
label 255 adds 0 and still counts), the optimizer Adam (b1 0.9, b2 0.999,
eps 1e-8 outside the square root, bias-corrected) at the recipe's learning
rate.  BatchNorm normalizes with the statistics of the whole batch, held
out of the gradient, so a batch is processed in blocks of rows: three
no-gradient passes gather each EdgeConv's statistics in turn, then each
block's forward and backward add its share of the gradient.

`windows` derives a step's batch from the training shards as the
reference's data pipeline defines it: windows of `context` rows in a
random permutation of all shards' windows per epoch, occupancy shifted to
0..254, (level, octant, occupancy) channels, the node's own position
min-max normalized per window.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.ehem import Reference

ADAM = (0.9, 0.999, 1e-8)


def leaf_norms(tensors: dict, sep: str, out_axis: int) -> dict:
    """{leaf: norm} with the fused attention projections split into the
    published query / key / value leaves (a key's bias has no gradient under
    softmax, so it must be a leaf of its own)."""
    out = {}
    for name, t in tensors.items():
        *scope, layer, leaf = name.split(sep)
        if layer in ("qkv", "kv"):
            parts = ("query", "key", "value") if layer == "qkv" else ("key", "value")
            for part, chunk in zip(parts, torch.chunk(t, len(parts), dim=out_axis)):
                out[sep.join([*scope, part, leaf])] = float(chunk.detach().float().norm())
        else:
            out[name] = float(t.detach().float().norm())
    return out


def window_index(rows_per_file, context):
    return [(fi, w) for fi, r in enumerate(rows_per_file) for w in range(r // context)]


def global_batch(shards, context, global_bs, seed, step):
    """The rows of global batch `step` (epoch-major permutation, the
    epoch's generator seeded with (seed, epoch)) -> data (B, N, 4, 3) int32,
    pos (B, N, 3) f32, label (B, N) int32."""
    index = window_index([s.shape[0] for s in shards], context)
    n_win = len(index)
    spe = max(n_win // global_bs, 1)
    epoch, i = divmod(step, spe)
    perm = np.random.default_rng([seed, epoch]).permutation(n_win)
    data, pos, label = [], [], []
    for j in range(global_bs):
        fi, w = index[perm[(i * global_bs + j) % n_win]]
        rows = np.array(shards[fi][w * context:(w + 1) * context])
        rows[:, :, 0] -= 1
        p = rows[:, -1, 3:6].astype(np.float32)
        lo, hi = p.min(), p.max()
        pos.append((p - lo) / (hi - lo + 1e-9))
        d = np.concatenate((rows[:, :, 1:3], rows[:, :, :1]), axis=2)
        data.append(d.astype(np.int32))
        label.append(d[:, -1, 2].astype(np.int32))
    return np.stack(data), np.stack(pos), np.stack(label)


class _Stop(Exception):
    pass


def _edge_stats(model, data, pos, block):
    """Each EdgeConv's batch statistics over the whole batch, in turn."""
    model.edge_stats = {}
    for name in ("conv1", "conv2", "conv3"):
        s1 = s2 = None
        cnt = 0
        for b0 in range(0, data.shape[0], block):
            model.collect = name
            try:
                model.geo(data[b0:b0 + block], pos[b0:b0 + block])
            except _Stop:
                pass
            e = model.collected
            s1 = e.sum(dim=(0, 1, 2)) if s1 is None else s1 + e.sum(dim=(0, 1, 2))
            s2 = (e * e).sum(dim=(0, 1, 2)) if s2 is None else s2 + (e * e).sum(dim=(0, 1, 2))
            cnt += e.shape[0] * e.shape[1] * e.shape[2]
            del e, model.collected
        mean = s1 / cnt
        model.edge_stats[name] = (mean, (s2 / cnt - mean * mean).clamp(min=0.0))
    model.collect = None


class TrainReference(Reference):
    """Reference in train mode whose EdgeConv can stop a forward after the
    edge tensor of `collect` (for the statistics pass)."""

    collect = None

    def edge_conv(self, feats, idx, name):
        if self.collect == name:
            b, n, c = feats.shape
            nb = feats.reshape(b * n, c)[(idx + torch.arange(b, device=idx.device)[:, None, None]
                                          * n).reshape(-1)].reshape(b, n, idx.shape[-1], c)
            ctr = feats[:, :, None, :].expand_as(nb)
            self.collected = self.mm(torch.cat([nb - ctr, ctr], -1),
                                     self.p[f"geo/{name}/conv/kernel"]).detach()
            raise _Stop
        return super().edge_conv(feats, idx, name)


def loss_and_grads(model, data, pos, label, block):
    """Mean bits per node of the batch and the gradient of every parameter."""
    params = model.p
    for t in params.values():
        t.requires_grad_(True)
        t.grad = None
    with torch.no_grad():
        _edge_stats(model, data, pos, block)
    total = data.shape[0] * data.shape[1]
    loss = 0.0
    for b0 in range(0, data.shape[0], block):
        logits = model.forward(data[b0:b0 + block], pos[b0:b0 + block])
        lab = label[b0:b0 + block].long()
        logp = torch.log_softmax(logits, -1)
        hit = torch.where(lab[..., None] == torch.arange(logp.shape[-1], device=lab.device),
                          logp, 0.0).sum(-1)
        part = -hit.sum() / total / math.log(2.0)
        part.backward()
        loss += float(part.detach())
        del logits, logp, hit, part
    grads = {k: t.grad.detach().clone() for k, t in params.items()}
    for t in params.values():
        t.requires_grad_(False)
        t.grad = None
    return loss, grads


class Adam:
    def __init__(self, params, lr):
        self.lr = lr
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params, grads):
        b1, b2, eps = ADAM
        self.t += 1
        for k, g in grads.items():
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            mh = self.m[k] / (1 - b1 ** self.t)
            vh = self.v[k] / (1 - b2 ** self.t)
            params[k].sub_(self.lr * mh / (vh.sqrt() + eps))


def reference_steps(params, stats, widths, static_knn, batches, lr, device, block=4,
                    precision="f32"):
    """Run the reference from `params` through `batches` ([(data, pos,
    label)] numpy); returns (losses, first gradient norms by leaf, change
    norms by leaf after the last step)."""
    start = {k: v.detach().clone() for k, v in params.items()}
    model = TrainReference(params, stats, widths, static_knn, precision=precision)
    model.train_mode = True
    opt = Adam(params, lr)
    losses, g1 = [], None
    for data, pos, label in batches:
        d, p, y = (torch.from_numpy(np.ascontiguousarray(x)).to(device)
                   for x in (data, pos, label))
        model.knn_cache = {}
        loss, grads = loss_and_grads(model, d, p, y, block)
        model.knn_cache = None
        if g1 is None:
            g1 = leaf_norms(grads, "/", -1)
        opt.step(params, grads)
        losses.append(loss)
        del grads
    change = leaf_norms({k: params[k] - start[k] for k in params}, "/", -1)
    return losses, g1, change
