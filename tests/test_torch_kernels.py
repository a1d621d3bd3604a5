"""The port's CUDA kernels against their plain PyTorch versions, on the
card (marker `cuda`; they skip without one: a CUDA kernel has no CPU
mode).  This file imports no JAX, so it also runs on a machine that has
none (conftest.py imports JAX, so leave it out):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from scp_tpu_torch.ops import knn_topk as tknn
from scp_tpu_torch.ops import mlp as tmlp
from scp_tpu_torch.ops import swin_attn as tswin
from scp_tpu_torch.ops import window_attn as twattn

TOL = 3e-2  # bf16 outputs: kernel and plain version round at the same points


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_a_matches_plain_on_card(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    m, c, f = 1000, 256, 1024  # ragged token count: the last row tile is partial

    def r(*s, scale=1.0):
        return torch.randn(*s, generator=g, device=cuda_device) * scale

    args = (r(m, c).bfloat16(), 1 + r(c, scale=0.1), r(c, scale=0.1),
            r(f, c, scale=0.05).bfloat16(), r(f, scale=0.05),
            r(c, f, scale=0.05).bfloat16(), r(c, scale=0.05), 1e-5)
    for act in ("gelu", "leaky"):
        n0 = tmlp.ln_mlp_residual.launches
        got = tmlp.ln_mlp_residual(*args, act)
        assert tmlp.ln_mlp_residual.launches == n0 + 1
        torch.testing.assert_close(got.float(), tmlp.ln_mlp_residual_plain(*args, act).float(),
                                   atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n_masks", [1, 4])
def test_kernels_b_c_match_plain_on_card(cuda_device, n_masks):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    bn, w, c, h = 4, 512, 256, 4

    def r(*s, scale=1.0):
        return torch.randn(*s, generator=g, device=cuda_device) * scale

    mask = torch.where(torch.rand(n_masks, w, w, generator=g, device=cuda_device) < 0.1,
                       -100.0, 0.0)
    x, qs = r(bn, w, c).bfloat16(), r(bn, w, c).bfloat16()
    ln = (1 + r(c, scale=0.1), r(c, scale=0.1))
    rel = r(h, w, w, scale=0.2)
    wp, bp = r(c, c, scale=0.05).bfloat16(), r(c, scale=0.05)
    self_args = (x, *ln, r(3 * c, c, scale=0.05).bfloat16(), r(3 * c, scale=0.05), rel,
                 mask, wp, bp, h, 1e-5)
    torch.testing.assert_close(tswin.attn_sublayer_self(*self_args).float(),
                               tswin.attn_sublayer_self_plain(*self_args).float(),
                               atol=TOL, rtol=TOL)
    cross_args = (x, qs, *ln, r(c, c, scale=0.05).bfloat16(), r(c, scale=0.05),
                  r(2 * c, c, scale=0.05).bfloat16(), r(2 * c, scale=0.05), rel, mask,
                  wp, bp, h, 1e-5)
    torch.testing.assert_close(tswin.attn_sublayer_cross(*cross_args).float(),
                               tswin.attn_sublayer_cross_plain(*cross_args).float(),
                               atol=TOL, rtol=TOL)


def _same_neighbors(got, want, feats, min_rows=0.999, rtol=1e-5):
    """Index lists identical on >= min_rows of the rows; on every row the
    sorted exact (f64) distances of both picks agree within rtol."""
    assert got.shape == want.shape and got.dtype == torch.int64
    same = (got == want).all(-1).float().mean().item()
    assert same >= min_rows, same
    f = feats.double()

    def dists(idx):
        nb = torch.gather(f[:, None].expand(-1, idx.shape[1], -1, -1), 2,
                          idx[..., None].expand(-1, -1, -1, f.shape[-1]))
        return ((nb - f[:, :, None]) ** 2).sum(-1).sort(-1).values

    dg, dw = dists(got), dists(want)
    assert torch.all((dg - dw).abs() <= rtol * dw.abs() + 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 144, 192])
def test_kernel_d_matches_plain_on_card(cuda_device, c):
    g = torch.Generator(device=cuda_device).manual_seed(c)
    n = 2048 + 37  # ragged: the last query and key tiles are partial
    feats = torch.randn(2, n, c, generator=g, device=cuda_device).bfloat16()
    n0 = tknn.knn_topk.launches
    got = tknn.knn_topk(feats, 20)
    assert tknn.knn_topk.launches == n0 + 1
    _same_neighbors(got, tknn.knn_topk_plain(feats, 20), feats)
    assert torch.equal(got, tknn.knn_topk(feats, 20))  # launches are deterministic
    f32 = feats.float()
    _same_neighbors(tknn.knn_topk(f32, 20), tknn.knn_topk_plain(f32, 20), f32)


@pytest.mark.cuda
def test_kernel_d_duplicate_points_take_the_lowest_index(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(9)
    n = 2048 + 37
    # a coarse grid: every score is exact in f32 and duplicates abound
    feats = (torch.randint(0, 8, (1, n, 3), generator=g, device=cuda_device) / 8.0).bfloat16()
    got = tknn.knn_topk(feats, 20)
    assert torch.equal(got, tknn.knn_topk_plain(feats, 20))
    f = feats[0].double().cpu().numpy()
    d = ((f[:, None] - f[None]) ** 2).sum(-1)
    cols = np.arange(n)
    for i in range(0, n, 97):
        assert got[0, i].tolist() == np.lexsort((cols, d[i]))[:20].tolist()


@pytest.mark.cuda
def test_kernel_d_refuses_what_it_does_not_take(cuda_device):
    feats = torch.randn(1, 2048, 3, device=cuda_device)
    with pytest.raises(ValueError):
        tknn.knn_topk(feats, 33)
    with pytest.raises(ValueError):
        tknn.knn_topk(torch.randn(1, 2048, 300, device=cuda_device), 20)
    with pytest.raises(ValueError):
        tknn.knn_topk(feats.half(), 20)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("n_masks", [1, 4])
def test_kernel_e_matches_plain_on_card(cuda_device, hd, n_masks):
    g = torch.Generator(device=cuda_device).manual_seed(hd + n_masks)
    bn, h, w = 6, 4, 512  # 6 windows over 4 masks: window n uses mask n % 4

    def r(*s, scale=1.0):
        return torch.randn(*s, generator=g, device=cuda_device) * scale

    q, k, v = (r(bn, h, w, hd).bfloat16() for _ in range(3))
    bias = r(h, w, w, scale=0.5)
    mask = torch.where(torch.rand(n_masks, w, w, generator=g, device=cuda_device) < 0.2,
                       -100.0, 0.0)
    n0 = twattn.window_attention.launches
    got = twattn.window_attention(q, k, v, bias, mask, hd ** -0.5)
    assert twattn.window_attention.launches == n0 + 1
    torch.testing.assert_close(got.float(),
                               twattn.window_attention_plain(q, k, v, bias, mask,
                                                             hd ** -0.5).float(),
                               atol=TOL, rtol=TOL)


@pytest.mark.cuda
def test_kernel_e_refuses_what_it_does_not_take(cuda_device):
    def qkv(w, hd):
        return torch.randn(2, 4, w, hd, device=cuda_device).bfloat16()

    bias, mask = torch.zeros(4, 192, 192, device=cuda_device), torch.zeros(1, 192, 192,
                                                                           device=cuda_device)
    with pytest.raises(ValueError):  # W not a multiple of 128
        twattn.window_attention(qkv(192, 64), qkv(192, 64), qkv(192, 64), bias, mask, 0.125)
    q = qkv(128, 64)
    with pytest.raises(ValueError):  # a bias left on the CPU
        twattn.window_attention(q, q, q, torch.zeros(4, 128, 128), mask[:, :128, :128], 0.125)
    q16 = qkv(128, 16)
    with pytest.raises(ValueError):  # head dim the kernel does not take
        twattn.window_attention(q16, q16, q16, bias[:, :128, :128], mask[:, :128, :128], 0.25)

