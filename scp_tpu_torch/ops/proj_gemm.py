"""The bf16 projection GEMM of kernels B and C, on its own.

`linear` computes  act(prologue(a) w^T + bias) (+ resid)  with the
numerics of the Swin sublayers' projections: the optional LayerNorm
prologue in f32 (two-pass statistics), its value rounded to bf16 before
the product; f32 accumulation; the bias, the activation and the residual
in f32; the result rounded to bf16.  `w` is (N, K) in nn.Linear's layout.

Kernels B and C launch this GEMM inside their own launchers
(csrc/swin_attn.cu); this wrapper launches it alone, for the card tests
and for chip_smoke.py's products-only yardstick.  A CPU tensor runs the
plain version; a CUDA tensor launches the kernel of the arm `arm` picks,
by shape alone, or raises:

  * "sm90": the Hopper wgmma + TMA GEMM (csrc/gemm_sm90.cuh), for
    K % 64 == 0 up to 256 and N % 64 == 0 (the A rows stay resident);
  * "wmma": the WMMA GEMM of csrc/common.cuh, for K > 256.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from scp_tpu_torch.ops import _cuda, mlp

ACTS = {None: 0, "gelu": 1, "leaky": 2}
SM90_MAX_K = 256  # csrc/gemm_sm90.cuh: SM90_MAXK, the resident A tile


def arm(n: int, k: int) -> str:
    """The bf16 GEMM arm for an (M, K) x (N, K)^T product; the launcher's
    own rule (gemm_sm90_fits), so a shape reaches only a kernel that takes
    it.  Shapes neither arm takes (K or N not a multiple of 64 or 32) are
    refused by `linear`."""
    if k % 64 == 0 and k <= SM90_MAX_K and n % 64 == 0:
        return "sm90"
    return "wmma"


def _ln(x32, scale, bias, eps):
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + eps) * scale + bias


def linear_plain(a, w, bias, act=None, ln=None, resid=None, eps: float = 1e-5):
    """Plain version: a (M, K) -> (M, N) in a's dtype.  ln = (scale, bias)
    of the LayerNorm prologue, or None."""
    h = a.float()
    if ln is not None:
        h = _ln(h, ln[0].float(), ln[1].float(), eps).to(a.dtype).float()
    y = F.linear(h, w.float()) + bias.float()
    if act is not None:
        y = mlp._act(y, act)
    if resid is not None:
        y = resid.float() + y
    return y.to(a.dtype)


def _check_rows(name, t, rows, cols):
    """A 2-D bf16 CUDA view with unit column stride, a row stride that is a
    multiple of 8 elements and a 16-byte aligned start (TMA and 16-byte
    row loads); returns the row stride."""
    if not t.is_cuda or t.dtype != torch.bfloat16:
        raise ValueError(f"{name}: expected a bf16 CUDA tensor, got {t.dtype} on {t.device}")
    if tuple(t.shape) != (rows, cols) or t.stride(1) != 1:
        raise ValueError(f"{name}: expected a ({rows}, {cols}) view with unit column stride, "
                         f"got shape {tuple(t.shape)} strides {t.stride()}")
    if t.stride(0) % 8 or t.data_ptr() % 16:
        raise ValueError(f"{name}: row stride {t.stride(0)} not a multiple of 8 elements or "
                         f"start not 16-byte aligned")
    return t.stride(0)


def linear(a, w, bias, act=None, ln=None, resid=None, out=None, eps: float = 1e-5):
    """a (M, K) -> act(prologue(a) w^T + bias) (+ resid), (M, N) bf16;
    written into `out` when given (an (M, N) view, e.g. a column slice of
    a wider buffer)."""
    m, k = a.shape
    n = w.shape[0]
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if w.ndim != 2 or w.shape[1] != k:
        raise ValueError(f"w: expected (N, {k}), got {tuple(w.shape)}")
    if a.device.type == "cpu":
        y = linear_plain(a, w, bias, act, ln, resid, eps)
        if out is None:
            return y
        out.copy_(y)
        return out
    if k % 32 or n % 64:
        raise ValueError(f"proj GEMM kernel: unsupported N={n}, K={k}")
    which = arm(n, k)
    lda = _check_rows("a", a, m, k)
    _cuda.check_cuda_tensor("w", w, torch.bfloat16, (n, k))
    _cuda.check_cuda_tensor("bias", bias, torch.float32, (n,))
    ln_ptrs = (None, None)
    if ln is not None:
        _cuda.check_cuda_tensor("ln scale", ln[0], torch.float32, (k,))
        _cuda.check_cuda_tensor("ln bias", ln[1], torch.float32, (k,))
        ln_ptrs = (ln[0].data_ptr(), ln[1].data_ptr())
    ldr = _check_rows("resid", resid, m, n) if resid is not None else 0
    if out is None:
        out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    ldo = _check_rows("out", out, m, n)
    lib = _cuda.load("swin_attn.cu")
    with _cuda.on_device(a, w, bias, *(ln or ()), resid, out):
        code = lib.scp_proj_gemm(
            a.data_ptr(), lda, *ln_ptrs, float(eps), w.data_ptr(), bias.data_ptr(),
            None if resid is None else resid.data_ptr(), ldr, out.data_ptr(), ldo, m, n, k,
            ACTS[act], int(which == "sm90"), _cuda.stream_ptr(a),
        )
    _cuda.check(lib, code, f"proj GEMM ({which})")
    linear.launches += 1
    linear.arms[which] += 1
    return out


linear.launches = 0
linear.arms = {"sm90": 0, "wmma": 0}
