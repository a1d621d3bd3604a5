"""Staged (two-nibble) entropy coding — the CDF factorization on the
device (the twin of scp_tpu/codec/staged.py).

Each occupancy symbol is factored into two 16-way stages,

    sym = hi * 16 + lo,   hi = sym >> 4,  lo = sym & 15,

and hi is coded against P(hi) = sum_lo P(sym), then lo against the exact
conditional P(lo | hi).  P(hi) * P(lo | hi) == P(sym), so the rate is the
255-way rate up to each stage's 16-bit quantization.  Per node the encoder
fetches the two (c_low, c_high) interval pairs (8 B) and the decoder two
17-entry rows (68 B) instead of one 256-entry row (512 B).

Bit-exactness contract: encoder and decoder derive their intervals from
identical quantized CDFs.  Both run `staged_cdfs` on the same device, on
tensors of one shape and layout coming out of the same phase calls, and
the interval / row extraction below is integer gathering over its rows.

The alphabet is padded from 255 to 256 symbols; symbol 255 (the pad
token) is never coded, so its zero probability costs only its ramp slot.
Rows are int32 tensors holding uint16 values (PyTorch has no uint16
arithmetic on every version); the host hands them to the coder as uint16.
"""

from __future__ import annotations

import numpy as np
import torch

N_STAGE = 16  # 2 stages of 16 -> 256-symbol alphabet


def quantize_cdf_device(cdf: torch.Tensor) -> torch.Tensor:
    """Float32 CDF rows (..., Lp) in [0, 1] -> strictly increasing int32
    rows of uint16 values (scp_tpu's construction, in f32 end to end).

    Only the final entry (== 1.0) wraps to 0 mod 2^16; every consumer
    reads it as 65536.  The cummax keeps a row monotone where a parallel
    cumsum on the card rounds an entry below its predecessor (the same
    guard as `ehem_codec.logits_to_cdf`); where the sums are monotone, as
    on the CPU, it changes nothing."""
    lp = cdf.shape[-1]
    scaled = cdf * torch.tensor(float((1 << 16) - (lp - 1)), dtype=torch.float32)
    q = torch.cummax(torch.round(scaled).to(torch.int32), dim=-1).values
    q = q + torch.arange(lp, dtype=torch.int32, device=q.device)
    return q & 0xFFFF


def staged_cdfs(logits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """logits (..., 255) -> (hi_cdf (..., 17), cond_cdf (..., 16, 17)).

    hi_cdf quantizes the marginal over the high nibble; cond_cdf row h
    quantizes P(lo | hi = h).  All-zero conditionals (underflowed softmax
    rows) degrade to the quantization ramp: still strictly increasing,
    still codable."""
    x = logits.float()
    x = x - x.amax(dim=-1, keepdim=True)
    p = torch.exp(x)
    p = p / p.sum(dim=-1, keepdim=True)
    p = torch.nn.functional.pad(p, (0, 1))  # (..., 256); symbol 255 gets probability 0
    p16 = p.reshape(*p.shape[:-1], N_STAGE, N_STAGE).contiguous()

    hi_cum = torch.cumsum(p16.sum(dim=-1), dim=-1)  # (..., 16)
    hi_cdf = hi_cum / hi_cum[..., -1:]
    hi_cdf = torch.cat([torch.zeros_like(hi_cdf[..., :1]), hi_cdf], dim=-1)

    c = torch.cumsum(p16, dim=-1)  # (..., 16, 16)
    denom = torch.clamp(c[..., -1:], min=1e-30)
    cond = torch.cat([torch.zeros_like(c[..., :1]), c / denom], dim=-1)
    return quantize_cdf_device(hi_cdf), quantize_cdf_device(cond)


def gather_cond_rows(cond_cdf: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Select conditional rows: cond_cdf (..., 16, 17), hi (...,) int
    -> (..., 17).  Integer gather: exact on any device."""
    idx = hi.to(torch.int64)[..., None, None].expand(*hi.shape, 1, cond_cdf.shape[-1])
    return torch.gather(cond_cdf, -2, idx)[..., 0, :]


def intervals(hi_cdf: torch.Tensor, cond_cdf: torch.Tensor, syms: torch.Tensor) -> torch.Tensor:
    """Per-symbol coding intervals (..., 2, 2): [..., 0, :] = (c_low,
    c_high) of the hi stage, [..., 1, :] = those of the lo stage.  A
    c_high of 0 means 65536 (the wrapped CDF top)."""
    syms = syms.to(torch.int64)
    hi = syms >> 4
    lo = syms & (N_STAGE - 1)

    def pick(rows, i):
        return torch.gather(rows, -1, i[..., None])[..., 0]

    hi_pair = torch.stack([pick(hi_cdf, hi), pick(hi_cdf, hi + 1)], dim=-1)
    row = gather_cond_rows(cond_cdf, hi)
    lo_pair = torch.stack([pick(row, lo), pick(row, lo + 1)], dim=-1)
    return torch.stack([hi_pair, lo_pair], dim=-2)


# ---- host-side reference implementations (tests / oracle) ----------------


def staged_cdfs_np(logits: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Numpy mirror of staged_cdfs for tests (scp_tpu's oracle).  Not
    guaranteed bit-identical to the tensor version (another order of
    operations); the codec never mixes the two within one stream."""
    x = logits.astype(np.float32)
    x = x - x.max(axis=-1, keepdims=True)
    p = np.exp(x)
    p = p / p.sum(axis=-1, keepdims=True)
    p = np.concatenate([p, np.zeros_like(p[..., :1])], axis=-1)
    p16 = p.reshape(*p.shape[:-1], N_STAGE, N_STAGE)

    def quant(cdf):
        lp = cdf.shape[-1]
        scaled = cdf * np.float32((1 << 16) - (lp - 1))
        q = np.round(scaled).astype(np.int64) + np.arange(lp, dtype=np.int64)
        return (q & 0xFFFF).astype(np.uint16)

    hi_cum = np.cumsum(p16.sum(axis=-1), axis=-1)
    hi_cdf = hi_cum / hi_cum[..., -1:]
    hi_cdf = np.concatenate([np.zeros_like(hi_cdf[..., :1]), hi_cdf], axis=-1)
    c = np.cumsum(p16, axis=-1)
    denom = np.maximum(c[..., -1:], np.float32(1e-30))
    cond = np.concatenate([np.zeros_like(c[..., :1]), c / denom], axis=-1)
    return quant(hi_cdf), quant(cond)


def staged_bits_np(hi_cdf: np.ndarray, cond_cdf: np.ndarray, syms: np.ndarray) -> float:
    """Ideal (pre-coder) bits of symbols under the staged quantized model:
    the rate oracle of the tests."""
    syms = syms.astype(np.int64)
    hi, lo = syms >> 4, syms & 15

    def width(rows, idx):
        lp = rows.shape[-1]
        a = np.take_along_axis(rows.astype(np.int64), idx[..., None], -1)[..., 0]
        bsel = np.take_along_axis(rows.astype(np.int64), idx[..., None] + 1, -1)[..., 0]
        bsel = np.where((idx + 1) == lp - 1, 1 << 16, bsel)
        return (bsel - a).clip(1)

    w_hi = width(hi_cdf, hi)
    rows = np.take_along_axis(
        cond_cdf, hi[..., None, None].repeat(cond_cdf.shape[-1], -1), -2
    )[..., 0, :]
    w_lo = width(rows, lo)
    return float(-(np.log2(w_hi / 65536.0) + np.log2(w_lo / 65536.0)).sum())
