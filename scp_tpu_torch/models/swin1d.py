"""1-D Swin transformer encoder for EHEM (port of scp_tpu/models/swin1d.py).

  * window attention over (B, nW, W, C) blocks with a 1-D relative
    position bias table of size 2W-1, bias[i, j] = table[i - j + W - 1];
  * shifted windows on odd blocks (roll by -W/2) with the three-zone
    additive mask;
  * patch merging halves the sequence; in cross mode the same merging
    weights downsample the query stream in lockstep;
  * cross attention reads Q from the query stream and residual-updates
    the key/value stream;
  * inputs shorter than a window are zero-padded up to one window.

The two sublayers dispatch at the same seams as scp_tpu: the attention
sublayer (swin1d.py:171-217) goes to ops.swin_attn when the sequence
tiles the window exactly, and the MLP sublayer (:244-263) to ops.mlp.
Those ops run their hand-written kernels (bf16 or f32) on a CUDA tensor
and their plain versions on a CPU tensor.  A padded sequence keeps the
unfused path (:221-234) of plain tensor ops; with `pallas_attn` (scp_tpu's
SCP_PALLAS_ATTN) its attention core goes to ops.window_attn, kernel E,
where the window passes that op's rule (swin1d.py:114-131).  Each op's
rule is scp_tpu's without the backend test, within its kernel's limits
(windows up to 512, head dims up to 256); a shape past them takes the
unfused plain ops on every device.

Each seam is a torch.autograd.Function (ops.mlp.LnMlpResidual,
ops.swin_attn.AttnSublayerSelf / AttnSublayerCross,
ops.window_attn.WindowAttention): the kernel forward, the backward of
scp_tpu's custom_vjps (autograd of the plain version).  The weights are
cast to the compute dtype outside the Function, as scp_tpu casts them
(swin1d.py:199-216, 256-262), so their gradients reach the f32 masters
through the cast.  `plain_seams` sends every seam to its plain version on
any device (for holding the kernels against it on the card).  With
`remat`, a stage in training mode recomputes each block in the backward
(torch.utils.checkpoint, scp_tpu's nn.remat(SwinBlock1D)).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from scp_tpu_torch.models.layers import Dense, LayerNorm
from scp_tpu_torch.ops import mlp as mlp_ops
from scp_tpu_torch.ops import swin_attn, window_attn

EPS = 1e-5  # LayerNorm epsilon of every Swin norm (flax SwinConfig.layer_norm_eps)


def _shift_mask(padded_len: int, window: int, shift: int) -> np.ndarray:
    """Additive (-100 off-zone) mask (nW, W, W) for shifted windows."""
    zones = np.zeros(padded_len, dtype=np.int32)
    zones[-window:-shift] = 1
    zones[-shift:] = 2
    zw = zones.reshape(-1, window)
    diff = zw[:, :, None] - zw[:, None, :]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _mask_tensor(padded_len: int, window: int, shift: int, device: torch.device):
    """Device copy of the shift mask, cached because every block of a
    stage reuses it.  Unshifted blocks pass no mask where scp_tpu passes a
    (1, W, W) zero mask: adding 0.0 changes no logit, and the kernels skip
    the read."""
    return torch.from_numpy(_shift_mask(padded_len, window, shift)).to(device)


class WindowAttention1D(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, cross: bool = False,
                 pallas_attn: bool = False, dtype=torch.float32, plain_seams: bool = False):
        super().__init__()
        self.dim, self.num_heads, self.window_size = dim, num_heads, window_size
        self.cross = cross
        self.pallas_attn = bool(pallas_attn)
        self.plain_seams = bool(plain_seams)
        self.dtype = dtype
        self.rel_pos_bias = nn.Parameter(torch.zeros(2 * window_size - 1, num_heads))
        if cross:
            self.query = Dense(dim, dim, dtype=dtype)
            self.kv = Dense(dim, 2 * dim, dtype=dtype)
        else:
            self.qkv = Dense(dim, 3 * dim, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)

    def rel_bias(self) -> torch.Tensor:
        """(H, W, W) f32 bias from the (2W-1, H) table."""
        w = self.window_size
        ar = torch.arange(w, device=self.rel_pos_bias.device)
        rel_idx = ar[:, None] - ar[None, :] + w - 1
        return self.rel_pos_bias[rel_idx].permute(2, 0, 1).contiguous()

    def forward(self, x, mask=None, query=None):
        """Unfused path. x (B, nW, W, C) windows; query same shape (cross)
        or None; mask (nW, W, W) additive or None."""
        h, w = self.num_heads, self.window_size
        hd = self.dim // h
        rel_bias = self.rel_bias()
        if self.cross:
            q = self.query(query)
            k, v = torch.chunk(self.kv(x), 2, dim=-1)
        else:
            q, k, v = torch.chunk(self.qkv(x), 3, dim=-1)
        b, nw = q.shape[:2]
        q, k, v = (t.reshape(b, nw, w, h, hd) for t in (q, k, v))
        if self.pallas_attn and window_attn.supported(w, hd):
            def heads_view(t):  # (B, nW, W, H, hd) -> (B*nW, H, W, hd), no copy
                return t.reshape(b * nw, w, h, hd).permute(0, 2, 1, 3)

            out = window_attn.WindowAttention.apply(
                heads_view(q), heads_view(k), heads_view(v), rel_bias, mask,
                1.0 / math.sqrt(hd), self.plain_seams,
            )
            out = out.permute(0, 2, 1, 3).reshape(b, nw, w, self.dim)
            return self.proj(out)
        dt = self.dtype
        scores = torch.einsum("bnqhd,bnkhd->bnhqk", q, k)
        scores = scores * torch.tensor(1.0 / math.sqrt(hd), dtype=dt)
        scores = scores + rel_bias[None, None].to(dt)
        if mask is not None:
            scores = scores + mask[None, :, None].to(dt)
        m = scores.amax(dim=-1, keepdim=True).detach()  # scp_tpu's stop_gradient
        e = torch.exp((scores - m).float()).to(dt)
        attn = e / e.float().sum(dim=-1, keepdim=True).to(dt)
        out = torch.einsum("bnhqk,bnkhd->bnqhd", attn, v)
        return self.proj(out.reshape(b, nw, w, self.dim))


class SwinBlock1D(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, mlp_ratio: float,
                 shift: int, cross: bool = False, pallas_attn: bool = False,
                 dtype=torch.float32, plain_seams: bool = False):
        super().__init__()
        self.dim, self.num_heads, self.window_size = dim, num_heads, window_size
        self.shift, self.cross = shift, cross
        self.dtype = dtype
        self.plain_seams = bool(plain_seams)
        self.norm1 = LayerNorm(dim, EPS)
        self.attn = WindowAttention1D(dim, num_heads, window_size, cross, pallas_attn, dtype,
                                      plain_seams)
        f = int(mlp_ratio * dim)
        self.norm2 = LayerNorm(dim, EPS)
        self.mlp1 = Dense(dim, f, dtype=dtype)
        self.mlp2 = Dense(f, dim, dtype=dtype)

    def forward(self, x, query=None):
        b, n, c = x.shape
        w = self.window_size
        pad = (-n) % w
        padded = n + pad
        shift = self.shift if padded > w else 0
        attn = self.attn

        if pad == 0 and swin_attn.supported(n, w, c, self.num_heads):
            mask = _mask_tensor(padded, w, shift, x.device) if shift else None

            def to_w(t):
                if shift:
                    t = torch.roll(t, -shift, dims=1)
                return t.reshape(b * (n // w), w, c).contiguous()

            n1 = self.norm1
            if self.cross:
                out = swin_attn.AttnSublayerCross.apply(
                    to_w(x), to_w(query), n1.weight, n1.bias,
                    attn.query.kernel(), attn.query.bias, attn.kv.kernel(), attn.kv.bias,
                    attn.rel_bias(), mask, attn.proj.kernel(), attn.proj.bias,
                    self.num_heads, EPS, self.plain_seams,
                )
            else:
                out = swin_attn.AttnSublayerSelf.apply(
                    to_w(x), n1.weight, n1.bias, attn.qkv.kernel(), attn.qkv.bias,
                    attn.rel_bias(), mask, attn.proj.kernel(), attn.proj.bias,
                    self.num_heads, EPS, self.plain_seams,
                )
            x = out.reshape(b, n, c)
            if shift:
                x = torch.roll(x, shift, dims=1)
        else:
            def to_windows(t):
                t = self.norm1(t).to(self.dtype)
                t = F.pad(t, (0, 0, 0, pad))
                if shift:
                    t = torch.roll(t, -shift, dims=1)
                return t.reshape(b, padded // w, w, c)

            xw = to_windows(x)
            qw = to_windows(query) if self.cross else None
            mask = _mask_tensor(padded, w, shift, x.device) if shift else None
            out = attn(xw, mask=mask, query=qw)
            out = out.reshape(b, padded, c)
            if shift:
                out = torch.roll(out, shift, dims=1)
            x = x + out[:, :n]

        f = self.mlp1.weight.shape[0]
        if mlp_ops.supported(c, f):
            n2 = self.norm2
            y = mlp_ops.LnMlpResidual.apply(
                x.reshape(b * n, c).contiguous(), n2.weight, n2.bias,
                self.mlp1.kernel(), self.mlp1.bias, self.mlp2.kernel(), self.mlp2.bias,
                EPS, "gelu", self.plain_seams,
            )
            return y.reshape(b, n, c)
        h = self.norm2(x)
        h = self.mlp1(h.to(self.dtype))
        h = F.gelu(h)
        h = self.mlp2(h)
        return x + h

    def flops(self, batch: int, n: int) -> int:
        """Forward products on (batch, n) tokens: the attention sublayer on
        whole (padded) windows, the MLP on the n tokens."""
        w, attn = self.window_size, self.attn
        padded = batch * (n + (-n) % w)
        qkv = (attn.query.flops(padded) + attn.kv.flops(padded) if self.cross
               else attn.qkv.flops(padded))
        core = 4 * padded * w * self.dim  # q.k^T and weights.v over each window
        return (qkv + core + attn.proj.flops(padded) + self.mlp1.flops(batch * n)
                + self.mlp2.flops(batch * n))


class PatchMerging1D(nn.Module):
    def __init__(self, in_dim: int, dim: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm = LayerNorm(2 * in_dim, EPS)
        self.reduce = Dense(2 * in_dim, dim, bias=False, dtype=dtype)

    def forward(self, x):
        if x.shape[1] % 2:
            x = F.pad(x, (0, 0, 0, 1))
        x = torch.cat([x[:, 0::2], x[:, 1::2]], dim=-1)  # (B, n/2, 2C)
        return self.reduce(self.norm(x).to(self.dtype))


class SwinStage1D(nn.Module):
    def __init__(self, dim: int, out_dim: int, depth: int, num_heads: int,
                 window_size: int, mlp_ratio: float, downsample: bool,
                 cross: bool = False, pallas_attn: bool = False, dtype=torch.float32,
                 remat: bool = False, plain_seams: bool = False):
        super().__init__()
        self.depth = depth
        self.cross = cross
        self.remat = bool(remat)
        for i in range(depth):
            self.add_module(f"block_{i}", SwinBlock1D(
                dim, num_heads, window_size, mlp_ratio,
                shift=0 if i % 2 == 0 else window_size // 2, cross=cross,
                pallas_attn=pallas_attn, dtype=dtype, plain_seams=plain_seams,
            ))
        self.merge = PatchMerging1D(dim, out_dim, dtype=dtype) if downsample else None

    def forward(self, x, query=None):
        recompute = self.remat and self.training and torch.is_grad_enabled()
        for i in range(self.depth):
            block = getattr(self, f"block_{i}")
            if recompute:
                x = checkpoint(block, x, query, use_reentrant=False)
            else:
                x = block(x, query=query)
        before = x
        if self.merge is not None:
            x = self.merge(before)
            if self.cross:
                query = self.merge(query)
        return x, before, query


class SwinEncoder1D(nn.Module):
    """Returns the per-stage pre-downsample hidden states, element 0 = the
    input.  Stage 0 runs at the input width `in_dim`; its merge and every
    later stage run at `embed_dim` (flax infers the same widths)."""

    def __init__(self, in_dim: int, embed_dim: int, depths, num_heads: int,
                 window_size: int, mlp_ratio: float, cross: bool = False,
                 pallas_attn: bool = False, dtype=torch.float32, remat: bool = False,
                 plain_seams: bool = False):
        super().__init__()
        self.n_stages = len(depths)
        # widths of the returned states[1:]: what a multiscale head reads
        self.stage_widths = [in_dim] + [embed_dim] * (self.n_stages - 1)
        for s, depth in enumerate(depths):
            dim = in_dim if s == 0 else embed_dim
            self.add_module(f"stage_{s}", SwinStage1D(
                dim, embed_dim, depth, num_heads, window_size, mlp_ratio,
                downsample=s < self.n_stages - 1, cross=cross, pallas_attn=pallas_attn,
                dtype=dtype, remat=remat, plain_seams=plain_seams,
            ))

    def forward(self, x, query=None):
        states = [x]
        for s in range(self.n_stages):
            x, before, query = getattr(self, f"stage_{s}")(x, query=query)
            states.append(before)
        return states

    def flops(self, batch: int, n: int):
        """(forward products on (batch, n) tokens, [(tokens per batch,
        width)] of the returned states[1:]: a multiscale head's pyramid)."""
        f, pyramid = 0, []
        for s in range(self.n_stages):
            stage = getattr(self, f"stage_{s}")
            f += sum(getattr(stage, f"block_{i}").flops(batch, n) for i in range(stage.depth))
            pyramid.append((n, self.stage_widths[s]))
            if stage.merge is not None:
                n = (n + 1) // 2
                f += stage.merge.reduce.flops(batch * n) * (2 if stage.cross else 1)
        return f, pyramid
