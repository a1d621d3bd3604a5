"""Fused EdgeConv training path: folded-BN gather + max with exact batch
statistics (port of scp_tpu/ops/edgeconv_fused.py).

The explicit train-mode EdgeConv builds the (B, N, k, F) edge tensor in
f32 for BatchNorm and runs normalize + leaky + max over it.  This path
computes the same forward function from one k-major gather:

  max_k leaky(BN(gather(a) + bc)) = leaky(s * (sel_k(gather(a)) + bc) + t)

with s = scale / sqrt(var + eps), t = bias - mean * s, and sel = max where
s >= 0, min where s < 0 (the per-channel affine is monotone across the k
neighbors, bc is constant across k, leaky_relu is monotone).  The
statistics are exact, one f32 pass over the gather:

  sum   (g + bc) = sum_k,m g   + k * sum_m bc
  sumsq (g + bc) = sum_k,m g^2 + 2 * sum_m bc * esum_m + k * sum_m bc^2

mean and var are detached: scp_tpu's declared stop-gradient through the
statistics (its module docstring; the dropped terms are O(1/k)).  Under
data-parallel training the sums s1, s2 and the count are summed over the
ranks first (train/distributed.py), so the statistics are the global
batch's, as scp_tpu takes them over its batch-sharded array.  The
gradient is autograd's own VJP of gather -> max/min, which routes each
channel's cotangent to the winning neighbors only (ties split evenly, as
JAX's max does).
"""

from __future__ import annotations

import torch

from scp_tpu_torch.train import distributed


def edgeconv_train_fused(a, bc, scale, bias, idx, eps: float = 1e-5, slope: float = 0.2):
    """a, bc (B, N, F) projected features (neighbor term, center term);
    scale, bias (F,) BatchNorm parameters; idx (B, N, k) neighbor indices
    into the same batch row.  Returns (out (B, N, F) in a.dtype, mean (F,)
    f32, var (F,) f32), mean and var the batch statistics of the virtual
    (B*N*k, F) edge tensor, detached (for the running-statistic update)."""
    b, n, f = a.shape
    k = idx.shape[-1]
    m = b * n
    base = (torch.arange(b, device=idx.device, dtype=idx.dtype) * n)[:, None, None]
    a_flat = a.reshape(m, f)
    bc32 = bc.reshape(m, f).float()
    km = (idx + base).movedim(-1, 0).reshape(-1)  # k-major flat order
    g = a_flat[km].reshape(k, m, f)
    gmax = g.amax(dim=0)
    gmin = g.amin(dim=0)

    with torch.no_grad():
        g32 = g.float()
        esum = g32.sum(dim=0)  # (M, F)
        gsq = (g32 * g32).sum(dim=(0, 1))  # (F,)
        del g32
        bc_sg = bc32.detach()
        cnt = torch.tensor(float(k * m), dtype=torch.float32)
        s1 = esum.sum(dim=0) + k * bc_sg.sum(dim=0)
        s2 = gsq + 2.0 * (bc_sg * esum).sum(dim=0) + k * (bc_sg * bc_sg).sum(dim=0)
        if distributed.world_size() > 1:
            s1, s2, cnt = (distributed.global_sum(x) for x in (s1, s2, cnt.to(s1.device)))
        mean = s1 / cnt
        var = torch.clamp(s2 / cnt - mean * mean, min=0.0)

    s = scale.float() * torch.rsqrt(var + eps)
    t = bias.float() - mean * s
    sel = torch.where(s >= 0, gmax, gmin).float() + bc32
    pre = s * sel + t
    out = torch.where(pre > 0, pre, slope * pre).to(a.dtype)
    return out.reshape(b, n, f), mean, var
