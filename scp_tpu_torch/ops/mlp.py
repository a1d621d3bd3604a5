"""Fused LayerNorm + MLP + residual: the Swin MLP sublayer (kernel A).

`ln_mlp_residual` computes  x + W2 act(W1 LN(x) + b1) + b2  and is the
port's counterpart of scp_tpu/ops/pallas_mlp.py::ln_mlp_residual (Pallas
kernel `_kernel`, pallas_call in `_fused_impl`).  Weights use nn.Linear's
layout: w1 (F, C), w2 (C, F), in x's dtype (bf16 or f32 on the card); LN
params and biases f32.

Dispatch is by the tensor's device: a CPU tensor runs the plain PyTorch
version (`ln_mlp_residual_plain`, written from pallas_mlp._reference); a
CUDA tensor launches the hand-written kernels in csrc/mlp.cu or raises.
On the card `kernel_arm` picks them by dtype and shape alone: bf16 at
C <= 256 the fused Hopper kernel ("sm90", no (M, F) intermediate), bf16
at C > 256 two WMMA GEMM launches ("wmma"), f32 two CUDA-core GEMM
launches ("f32").

`LnMlpResidual` is the seam the Swin blocks call: a torch.autograd.Function
whose forward is `ln_mlp_residual` (or, with `plain=True`, the plain
version on any device) and whose backward is autograd of the plain
version, recomputed from the saved inputs, as scp_tpu's custom_vjp does
(pallas_mlp.py:153-175).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from scp_tpu_torch.ops import _cuda
from scp_tpu_torch.ops.vjp import plain_vjp

ACTS = {"gelu": 1, "leaky": 2}
FUSED_MAX_C = 256  # csrc/mlp.cu: MLP_MAXC, the resident tile and fc2's accumulator


def supported(c: int, f: int) -> bool:
    """Shapes the kernel tiles (64-wide output tiles, 32-deep stages);
    the same rule on every device, so CPU and card take the same seam."""
    return c % 64 == 0 and f % 64 == 0


def kernel_arm(c: int, dtype) -> str:
    """Which kernel a supported (C, F) shape of this dtype takes on the
    card: "sm90" (fused), "wmma" or "f32" (two GEMM launches)."""
    if dtype == torch.float32:
        return "f32"
    return "sm90" if c <= FUSED_MAX_C else "wmma"


def _act(m: torch.Tensor, act: str) -> torch.Tensor:
    if act == "gelu":
        return F.gelu(m)  # exact erf form
    return F.leaky_relu(m, 0.01)


def ln_mlp_residual_plain(x, scale, bias, w1, b1, w2, b2, eps: float, act: str):
    """Plain version: x (M, C) -> x.dtype.  LN, activation and residual in
    f32; operands rounded to x.dtype before each product, which then
    accumulates in f32 (the f32 product of bf16 values is exact)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    h = (xf - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    h = h.to(x.dtype)
    m = F.linear(h.float(), w1.float()) + b1.float()
    m = _act(m, act)
    y = F.linear(m.to(x.dtype).float(), w2.float()) + b2.float()
    return (xf + y).to(x.dtype)


def ln_mlp_residual(x, scale, bias, w1, b1, w2, b2, eps: float, act: str):
    """x (M, C) -> x + act(LN(x) w1^T + b1) w2^T + b2 (see module doc)."""
    if x.device.type == "cpu":
        return ln_mlp_residual_plain(x, scale, bias, w1, b1, w2, b2, eps, act)
    m, c = x.shape
    f = w1.shape[0]
    if not supported(c, f):
        raise ValueError(f"ln_mlp_residual kernel: unsupported C={c}, F={f}")
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    flag = _cuda.dtype_flag(x)
    for name, t, dt, shape in (
        ("x", x, x.dtype, (m, c)),
        ("scale", scale, torch.float32, (c,)),
        ("bias", bias, torch.float32, (c,)),
        ("w1", w1, x.dtype, (f, c)),
        ("b1", b1, torch.float32, (f,)),
        ("w2", w2, x.dtype, (c, f)),
        ("b2", b2, torch.float32, (c,)),
    ):
        _cuda.check_cuda_tensor(name, t, dt, shape)
    arm = kernel_arm(c, x.dtype)
    lib = _cuda.load("mlp.cu")
    mid = None if arm == "sm90" else torch.empty((m, f), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    with _cuda.on_device(x, scale, bias, w1, b1, w2, b2):
        code = lib.scp_ln_mlp_residual(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), None if mid is None else mid.data_ptr(),
            out.data_ptr(), m, c, f, float(eps), ACTS[act], flag, int(arm == "sm90"),
            _cuda.stream_ptr(x),
        )
    _cuda.check(lib, code, f"ln_mlp_residual ({arm})")
    ln_mlp_residual.launches += 1
    ln_mlp_residual.arms[arm] += 1
    return out


ln_mlp_residual.launches = 0
ln_mlp_residual.arms = {"sm90": 0, "wmma": 0, "f32": 0}


class LnMlpResidual(torch.autograd.Function):
    """ln_mlp_residual with scp_tpu's gradient: apply(x, scale, bias, w1,
    b1, w2, b2, eps, act, plain).  The weights arrive already cast to the
    compute dtype, so their gradients flow back through the cast."""

    @staticmethod
    def forward(ctx, x, scale, bias, w1, b1, w2, b2, eps, act, plain):
        ctx.save_for_backward(x, scale, bias, w1, b1, w2, b2)
        ctx.consts = (eps, act)
        fn = ln_mlp_residual_plain if plain else ln_mlp_residual
        return fn(x, scale, bias, w1, b1, w2, b2, eps, act)

    @staticmethod
    def backward(ctx, g):
        return (*plain_vjp(ln_mlp_residual_plain, ctx, g, *ctx.consts), None, None, None)
