"""Fused Swin attention sublayer, x + proj(MHA(LN(x))) (kernels B and C).

`attn_sublayer_self` is the counterpart of
scp_tpu/ops/pallas_swin.py::attn_sublayer_self (Pallas `_self_kernel`,
pallas_call in `_self_impl`); `attn_sublayer_cross` of
`attn_sublayer_cross` (`_cross_kernel`, `_cross_impl`).  Layouts follow
the JAX package except the weights, which use nn.Linear's (out, in):
x (BN, W, C) windows; wqkv (3C, C); wq (C, C); wkv (2C, C); wp (C, C);
rel_bias (H, W, W) f32; mask (n_masks, W, W) f32 additive, window n uses
mask[n % n_masks], or None for no mask (the unshifted blocks).

Dispatch is by the tensor's device: a CPU tensor runs the plain version
(written from pallas_swin._reference_self / _reference_cross); a CUDA
tensor launches the kernels of csrc/swin_attn.cu (bf16 or f32: x, the
weights and the outputs in one of the two, LN parameters and biases f32)
or raises.  The attention between the projections is the core of
csrc/attn_core.cuh, which kernel E launches too.  The projections take
`gemm_arm`'s GEMM: bf16 at C <= 256 the Hopper wgmma + TMA GEMM
(csrc/gemm_sm90.cuh, "sm90"), bf16 at C > 256 the WMMA GEMM ("wmma"),
f32 the CUDA-core GEMM ("f32").

`AttnSublayerSelf` and `AttnSublayerCross` are the seams the Swin blocks
call: torch.autograd.Functions whose forward is the dispatching function
above (or, with `plain=True`, the plain version on any device) and whose
backward is autograd of the plain version, recomputed from the saved
inputs, as scp_tpu's custom_vjps do (pallas_swin.py:338-390).  The mask is
a constant and gets no gradient.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from scp_tpu_torch.ops import _cuda, proj_gemm
from scp_tpu_torch.ops.vjp import plain_vjp
from scp_tpu_torch.ops.window_attn import core_supported


def supported(n: int, w: int, c: int, heads: int) -> bool:
    """scp_tpu's rule (pallas_swin.supported: pad-free sequences of whole
    windows, c % 128 == 0, hd % 8 == 0) without its backend test, at
    windows of 64-row tiles, within the attention core's limits; the same
    on every device and the launcher's own test."""
    return (
        n % w == 0
        and c % 128 == 0
        and c % heads == 0
        and core_supported(w, c // heads)
    )


def gemm_arm(c: int, dtype) -> str:
    """The projection GEMM a supported sublayer of width C takes on the
    card, by dtype and shape alone: K = C and N in {C, 2C, 3C}."""
    if dtype == torch.float32:
        return "f32"
    return proj_gemm.arm(c, c)


def _ln(x32, scale, bias, eps):
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + eps) * scale + bias


def _proj(h, w, b, dtype):
    """(h w^T + b) with f32 accumulation, rounded to dtype."""
    return (F.linear(h.float(), w.float()) + b.float()).to(dtype)


def _attend_project(xf, q, k, v, rel_bias, mask, wp, bp, heads, dtype):
    bn, w, c = q.shape
    hd = c // heads

    def hsplit(t):
        return t.reshape(bn, w, heads, hd).float()

    s = torch.einsum("nqhd,nkhd->nhqk", hsplit(q), hsplit(k))
    s = s * torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    s = s + rel_bias[None].float()
    if mask is not None:
        mb = mask[torch.arange(bn, device=mask.device) % mask.shape[0]]
        s = s + mb[:, None].float()
    a = torch.softmax(s, dim=-1).to(dtype)
    att = torch.einsum("nhqk,nkhd->nqhd", a.float(), hsplit(v)).reshape(bn, w, c)
    y = F.linear(att.to(dtype).float(), wp.float()) + bp.float()
    return (xf + y).to(dtype)


def attn_sublayer_self_plain(x, scale, bias, wqkv, bqkv, rel_bias, mask, wp, bp,
                             heads: int, eps: float):
    c = x.shape[-1]
    xf = x.float()
    h = _ln(xf, scale.float(), bias.float(), eps).to(x.dtype)
    qkv = _proj(h, wqkv, bqkv, x.dtype)
    q, k, v = qkv[..., :c], qkv[..., c : 2 * c], qkv[..., 2 * c :]
    return _attend_project(xf, q, k, v, rel_bias, mask, wp, bp, heads, x.dtype)


def attn_sublayer_cross_plain(x, qs, scale, bias, wq, bq, wkv, bkv, rel_bias, mask,
                              wp, bp, heads: int, eps: float):
    c = x.shape[-1]
    xf = x.float()
    scl, bia = scale.float(), bias.float()
    hx = _ln(xf, scl, bia, eps).to(x.dtype)
    hq = _ln(qs.float(), scl, bia, eps).to(x.dtype)
    q = _proj(hq, wq, bq, x.dtype)
    kv = _proj(hx, wkv, bkv, x.dtype)
    return _attend_project(xf, q, kv[..., :c], kv[..., c:], rel_bias, mask, wp, bp,
                           heads, x.dtype)


def _check_common(x, scale, bias, rel_bias, mask, wp, bp, heads):
    bn, w, c = x.shape
    if not supported(w, w, c, heads):
        raise ValueError(f"attention kernel: unsupported W={w}, C={c}, heads={heads}")
    flag = _cuda.dtype_flag(x)
    if mask is not None:
        if mask.ndim != 3 or mask.shape[1:] != (w, w) or mask.shape[0] < 1:
            raise ValueError(f"mask: expected (n_masks, {w}, {w}), got {tuple(mask.shape)}")
        _cuda.check_cuda_tensor("mask", mask, torch.float32)
    for name, t, dt, shape in (
        ("x", x, x.dtype, (bn, w, c)),
        ("scale", scale, torch.float32, (c,)),
        ("bias", bias, torch.float32, (c,)),
        ("rel_bias", rel_bias, torch.float32, (heads, w, w)),
        ("wp", wp, x.dtype, (c, c)),
        ("bp", bp, torch.float32, (c,)),
    ):
        _cuda.check_cuda_tensor(name, t, dt, shape)
    return bn, w, c, flag, gemm_arm(c, x.dtype)


def _mask_args(mask):
    return (None, 0) if mask is None else (mask.data_ptr(), mask.shape[0])


def attn_sublayer_self(x, scale, bias, wqkv, bqkv, rel_bias, mask, wp, bp,
                       heads: int, eps: float):
    """x (BN, W, C) windows -> x + proj(window_attn(LN(x)))."""
    if x.device.type == "cpu":
        return attn_sublayer_self_plain(x, scale, bias, wqkv, bqkv, rel_bias, mask,
                                        wp, bp, heads, eps)
    bn, w, c, flag, arm = _check_common(x, scale, bias, rel_bias, mask, wp, bp, heads)
    _cuda.check_cuda_tensor("wqkv", wqkv, x.dtype, (3 * c, c))
    _cuda.check_cuda_tensor("bqkv", bqkv, torch.float32, (3 * c,))
    lib = _cuda.load("swin_attn.cu")
    dev = x.device
    qkv = torch.empty((bn * w, 3 * c), dtype=x.dtype, device=dev)
    att = torch.empty((bn * w, c), dtype=x.dtype, device=dev)
    out = torch.empty_like(x)
    with _cuda.on_device(x, scale, bias, wqkv, bqkv, rel_bias, mask, wp, bp):
        code = lib.scp_attn_self(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), wqkv.data_ptr(),
            bqkv.data_ptr(), rel_bias.data_ptr(), *_mask_args(mask),
            wp.data_ptr(), bp.data_ptr(), qkv.data_ptr(), att.data_ptr(),
            out.data_ptr(), bn, w, c, heads, float(eps), 1.0 / math.sqrt(c // heads), flag,
            int(arm == "sm90"), _cuda.stream_ptr(x),
        )
    _cuda.check(lib, code, f"attn_sublayer_self ({arm})")
    attn_sublayer_self.launches += 1
    attn_sublayer_self.arms[arm] += 1
    return out


def attn_sublayer_cross(x, qs, scale, bias, wq, bq, wkv, bkv, rel_bias, mask, wp, bp,
                        heads: int, eps: float):
    """Cross sublayer: Q from LN(qs), K|V from LN(x); residual x."""
    if x.device.type == "cpu":
        return attn_sublayer_cross_plain(x, qs, scale, bias, wq, bq, wkv, bkv, rel_bias,
                                         mask, wp, bp, heads, eps)
    bn, w, c, flag, arm = _check_common(x, scale, bias, rel_bias, mask, wp, bp, heads)
    _cuda.check_cuda_tensor("qs", qs, x.dtype, (bn, w, c))
    _cuda.check_cuda_tensor("wq", wq, x.dtype, (c, c))
    _cuda.check_cuda_tensor("bq", bq, torch.float32, (c,))
    _cuda.check_cuda_tensor("wkv", wkv, x.dtype, (2 * c, c))
    _cuda.check_cuda_tensor("bkv", bkv, torch.float32, (2 * c,))
    lib = _cuda.load("swin_attn.cu")
    dev = x.device
    qbuf = torch.empty((bn * w, c), dtype=x.dtype, device=dev)
    kvbuf = torch.empty((bn * w, 2 * c), dtype=x.dtype, device=dev)
    att = torch.empty((bn * w, c), dtype=x.dtype, device=dev)
    out = torch.empty_like(x)
    with _cuda.on_device(x, qs, scale, bias, wq, bq, wkv, bkv, rel_bias, mask, wp, bp):
        code = lib.scp_attn_cross(
            x.data_ptr(), qs.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            wq.data_ptr(), bq.data_ptr(), wkv.data_ptr(), bkv.data_ptr(),
            rel_bias.data_ptr(), *_mask_args(mask), wp.data_ptr(),
            bp.data_ptr(), qbuf.data_ptr(), kvbuf.data_ptr(), att.data_ptr(),
            out.data_ptr(), bn, w, c, heads, float(eps), 1.0 / math.sqrt(c // heads), flag,
            int(arm == "sm90"), _cuda.stream_ptr(x),
        )
    _cuda.check(lib, code, f"attn_sublayer_cross ({arm})")
    attn_sublayer_cross.launches += 1
    attn_sublayer_cross.arms[arm] += 1
    return out


attn_sublayer_self.launches = 0
attn_sublayer_cross.launches = 0
attn_sublayer_self.arms = {"sm90": 0, "wmma": 0, "f32": 0}
attn_sublayer_cross.arms = {"sm90": 0, "wmma": 0, "f32": 0}


class AttnSublayerSelf(torch.autograd.Function):
    """attn_sublayer_self with scp_tpu's gradient: apply(x, scale, bias,
    wqkv, bqkv, rel_bias, mask, wp, bp, heads, eps, plain)."""

    @staticmethod
    def forward(ctx, x, scale, bias, wqkv, bqkv, rel_bias, mask, wp, bp, heads, eps, plain):
        ctx.save_for_backward(x, scale, bias, wqkv, bqkv, rel_bias, mask, wp, bp)
        ctx.consts = (heads, eps)
        fn = attn_sublayer_self_plain if plain else attn_sublayer_self
        return fn(x, scale, bias, wqkv, bqkv, rel_bias, mask, wp, bp, heads, eps)

    @staticmethod
    def backward(ctx, g):
        return (*plain_vjp(attn_sublayer_self_plain, ctx, g, *ctx.consts), None, None, None)


class AttnSublayerCross(torch.autograd.Function):
    """attn_sublayer_cross with scp_tpu's gradient: apply(x, qs, scale,
    bias, wq, bq, wkv, bkv, rel_bias, mask, wp, bp, heads, eps, plain)."""

    @staticmethod
    def forward(ctx, x, qs, scale, bias, wq, bq, wkv, bkv, rel_bias, mask, wp, bp, heads, eps,
                plain):
        ctx.save_for_backward(x, qs, scale, bias, wq, bq, wkv, bkv, rel_bias, mask, wp, bp)
        ctx.consts = (heads, eps)
        fn = attn_sublayer_cross_plain if plain else attn_sublayer_cross
        return fn(x, qs, scale, bias, wq, bq, wkv, bkv, rel_bias, mask, wp, bp, heads, eps)

    @staticmethod
    def backward(ctx, g):
        return (*plain_vjp(attn_sublayer_cross_plain, ctx, g, *ctx.consts), None, None, None)
