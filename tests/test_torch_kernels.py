"""The port's CUDA kernels against their plain PyTorch versions, on the
card (marker `cuda`; they skip without one: a CUDA kernel has no CPU
mode).  This file imports no JAX, so it also runs on a machine that has
none (conftest.py imports JAX, so leave it out):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import pytest
import torch

from scp_tpu_torch.ops import mlp as tmlp
from scp_tpu_torch.ops import swin_attn as tswin

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
