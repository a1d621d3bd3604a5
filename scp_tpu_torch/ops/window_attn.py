"""Fused 1-D window attention (kernel E) and the attention core it shares
with kernels B and C.

`window_attention` is the port's counterpart of scp_tpu/ops/pallas_attn.py::
window_attention_fused (Pallas kernel `_kernel`, pallas_call in
`_fused_fwd_impl`): q, k, v (BN, H, W, hd); bias (H, W, W) f32; mask
(M, W, W) f32 additive, window n uses mask[n % M], or None for no mask ->
softmax(q k^T * scale + bias + mask) v in q's dtype, with the logits and
the softmax in f32 and the weights rounded to v's dtype before the
product.

Dispatch is by the tensor's device: a CPU tensor runs the plain version
(`window_attention_plain`, written from pallas_attn._reference); a CUDA
tensor launches the core of csrc/attn_core.cuh (bf16 or f32, every shape
`supported` admits) or raises.  On the card q, k and v may be strided
views (each head's hd values contiguous): the kernel reads them in place,
and the output is laid out (BN, W, H, hd) and returned as its
(BN, H, W, hd) view.

`WindowAttention` is the seam the Swin blocks call: a
torch.autograd.Function whose forward is `window_attention` (or, with
`plain=True`, the plain version on any device) and whose backward is
autograd of the plain version, recomputed from the saved inputs, as
scp_tpu's custom_vjp does (pallas_attn.py:86-103).
"""

from __future__ import annotations

import torch

from scp_tpu_torch.ops import _cuda
from scp_tpu_torch.ops.vjp import plain_vjp

MAX_WINDOW = 512  # the core keeps a query's whole score row in registers
MAX_HEAD_DIM = 256


def core_supported(w: int, hd: int) -> bool:
    """Shapes the attention core takes (kernels B, C and E): windows of
    64-row tiles up to MAX_WINDOW, head dims of 16-byte rows up to
    MAX_HEAD_DIM."""
    return 64 <= w <= MAX_WINDOW and w % 64 == 0 and 8 <= hd <= MAX_HEAD_DIM and hd % 8 == 0


def supported(w: int, hd: int) -> bool:
    """scp_tpu's rule (pallas_attn.supported) without its backend test,
    within the core's limits: the same on every device, and the launcher's
    own test, so the seam never sends the card a shape the kernel refuses.
    Larger windows or head dims take the unfused path everywhere."""
    return w >= 128 and w % 128 == 0 and core_supported(w, hd)


def window_attention_plain(q, k, v, bias, mask, scale: float):
    """Plain version, pallas_attn._reference line for line."""
    s = torch.einsum("nhqd,nhkd->nhqk", q.float(), k.float())
    s = s * torch.tensor(scale, dtype=torch.float32)
    s = s + bias[None].float()
    if mask is not None:
        mask_b = mask[torch.arange(q.shape[0], device=mask.device) % mask.shape[0]]
        s = s + mask_b[:, None].float()
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    a = (e / e.sum(dim=-1, keepdim=True)).to(q.dtype)
    return torch.einsum("nhqk,nhkd->nhqd", a.float(), v.float()).to(q.dtype)


def _check_heads(name: str, t, shape, dtype) -> None:
    """A (BN, H, W, hd) operand the core reads in place: on the card, the
    kernel's dtype, hd values contiguous, 16-byte aligned rows."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    per16 = 16 // t.element_size()
    if t.stride(-1) != 1 or any(s % per16 for s in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be contiguous and 16-byte aligned")


def launch_core(q, k, v, bias, mask, scale: float, out) -> None:
    """out[...] = softmax(q k^T * scale + bias + mask) v on the card, for
    (BN, H, W, hd) views q, k, v and out; checks, then one launch."""
    bn, h, w, hd = q.shape
    if not core_supported(w, hd):
        raise ValueError(f"attention core: unsupported W={w}, hd={hd}")
    flag = _cuda.dtype_flag(q)
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        _check_heads(name, t, (bn, h, w, hd), q.dtype)
    _cuda.check_cuda_tensor("bias", bias, torch.float32, (h, w, w))
    if mask is not None:
        if mask.ndim != 3 or mask.shape[1:] != (w, w) or mask.shape[0] < 1:
            raise ValueError(f"mask: expected (n_masks, {w}, {w}), got {tuple(mask.shape)}")
        _cuda.check_cuda_tensor("mask", mask, torch.float32)
    lib = _cuda.load("window_attn.cu")
    with _cuda.on_device(q, k, v, bias, mask, out):
        code = lib.scp_window_attn(
            *(x for t in (q, k, v, out) for x in (t.data_ptr(), *t.stride()[:3])),
            bias.data_ptr(), None if mask is None else mask.data_ptr(),
            0 if mask is None else mask.shape[0], bn, h, w, hd, float(scale), flag,
            _cuda.stream_ptr(q),
        )
    _cuda.check(lib, code, "attention core")


def window_attention(q, k, v, bias, mask, scale: float):
    """(BN, H, W, hd) windows -> softmax(q k^T * scale + bias + mask) v."""
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, bias, mask, scale)
    if q.ndim != 4:
        raise ValueError(f"window_attention: expected (BN, H, W, hd), got {tuple(q.shape)}")
    bn, h, w, hd = q.shape
    if not supported(w, hd):
        raise ValueError(f"window_attention kernel: unsupported W={w}, hd={hd}")
    out = torch.empty((bn, w, h, hd), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    launch_core(q, k, v, bias, mask, scale, out)
    window_attention.launches += 1
    return out


window_attention.launches = 0


class WindowAttention(torch.autograd.Function):
    """window_attention with scp_tpu's gradient: apply(q, k, v, bias, mask,
    scale, plain).  The mask is a constant and gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, scale, plain):
        ctx.save_for_backward(q, k, v, bias, mask)
        ctx.consts = (scale,)
        fn = window_attention_plain if plain else window_attention
        return fn(q, k, v, bias, mask, scale)

    @staticmethod
    def backward(ctx, g):
        return (*plain_vjp(window_attention_plain, ctx, g, *ctx.consts), None, None)
