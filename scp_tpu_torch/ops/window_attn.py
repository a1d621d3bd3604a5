"""Fused 1-D window attention (kernel E).

`window_attention` is the port's counterpart of scp_tpu/ops/pallas_attn.py::
window_attention_fused (Pallas kernel `_kernel`, pallas_call in
`_fused_fwd_impl`): q, k, v (BN, H, W, hd); bias (H, W, W) f32; mask
(M, W, W) f32 additive, window n uses mask[n % M] ->
softmax(q k^T * scale + bias + mask) v in q's dtype, with the logits and
the softmax in f32 and the weights rounded to v's dtype before the
product.

Dispatch is by the tensor's device: a CPU tensor runs the plain version
(`window_attention_plain`, written from pallas_attn._reference); a CUDA
tensor launches the kernel of csrc/window_attn.cu (bf16, hd 32 or 64) or
raises.
"""

from __future__ import annotations

import torch

from scp_tpu_torch.ops import _cuda

KERNEL_HEAD_DIMS = (32, 64)


def supported(w: int, hd: int) -> bool:
    """scp_tpu's rule (pallas_attn.supported) without its backend test:
    the same on every device, so CPU and card take the same seam."""
    return w >= 128 and w % 128 == 0 and hd % 8 == 0


def window_attention_plain(q, k, v, bias, mask, scale: float):
    """Plain version, pallas_attn._reference line for line."""
    mask_b = mask[torch.arange(q.shape[0], device=mask.device) % mask.shape[0]]
    s = torch.einsum("nhqd,nhkd->nhqk", q.float(), k.float())
    s = s * torch.tensor(scale, dtype=torch.float32)
    s = s + bias[None].float() + mask_b[:, None].float()
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    a = (e / e.sum(dim=-1, keepdim=True)).to(q.dtype)
    return torch.einsum("nhqk,nhkd->nhqd", a.float(), v.float()).to(q.dtype)


def window_attention(q, k, v, bias, mask, scale: float):
    """(BN, H, W, hd) windows -> softmax(q k^T * scale + bias + mask) v."""
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, bias, mask, scale)
    if q.ndim != 4:
        raise ValueError(f"window_attention: expected (BN, H, W, hd), got {tuple(q.shape)}")
    bn, h, w, hd = q.shape
    if not supported(w, hd) or hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"window_attention kernel: unsupported W={w}, hd={hd}")
    if mask.ndim != 3 or mask.shape[1:] != (w, w) or mask.shape[0] < 1:
        raise ValueError(f"mask: expected (n_masks, {w}, {w}), got {tuple(mask.shape)}")
    for name, t, dt, shape in (
        ("q", q, torch.bfloat16, (bn, h, w, hd)),
        ("k", k, torch.bfloat16, (bn, h, w, hd)),
        ("v", v, torch.bfloat16, (bn, h, w, hd)),
        ("bias", bias, torch.float32, (h, w, w)),
        ("mask", mask, torch.float32, None),
    ):
        _cuda.check_cuda_tensor(name, t, dt, shape)
    lib = _cuda.load("window_attn.cu")
    out = torch.empty_like(q)
    code = lib.scp_window_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), mask.data_ptr(),
        mask.shape[0], out.data_ptr(), bn, h, w, hd, float(scale), _cuda.stream_ptr(q),
    )
    _cuda.check(lib, code, "window_attention")
    window_attention.launches += 1
    return out


window_attention.launches = 0
