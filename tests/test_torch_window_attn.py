"""Kernel E's plain version (scp_tpu_torch/ops/window_attn.py) against the
Pallas kernel it replaces, scp_tpu/ops/pallas_attn.py::_fused_fwd_impl in
interpret mode (as tests/test_pallas_attn.py runs it), the seam rule, and
the Swin encoder with the switch on against JAX with SCP_PALLAS_ATTN=1.
The CUDA kernel itself is held against the plain version in
tests/test_torch_kernels.py, on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from scp_tpu.ops import pallas_attn
from scp_tpu_torch.ops import window_attn as twattn


def _inputs(rng, bn, h, w, hd, n_masks):
    q, k, v = (rng.normal(0.0, 1.0, (bn, h, w, hd)).astype(np.float32) for _ in range(3))
    bias = rng.normal(0.0, 0.5, (h, w, w)).astype(np.float32)
    mask = np.where(rng.random((n_masks, w, w)) < 0.2, -100.0, 0.0).astype(np.float32)
    return q, k, v, bias, mask


def test_plain_matches_pallas_f32():
    q, k, v, bias, mask = _inputs(np.random.default_rng(0), 6, 2, 128, 32, 3)
    want = pallas_attn._fused_fwd_impl(*map(jnp.asarray, (q, k, v, bias, mask)), 32 ** -0.5,
                                       interpret=True)
    got = twattn.window_attention_plain(*map(torch.from_numpy, (q, k, v, bias, mask)),
                                        32 ** -0.5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_plain_matches_pallas_bf16():
    q, k, v, bias, mask = _inputs(np.random.default_rng(1), 4, 4, 128, 64, 1)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = pallas_attn._fused_fwd_impl(*jb, jnp.asarray(bias), jnp.asarray(mask), 0.125,
                                       interpret=True)
    tb = [torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16() for a in jb]
    got = twattn.window_attention_plain(*tb, torch.from_numpy(bias), torch.from_numpy(mask),
                                        0.125)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=3e-2, rtol=0)


def test_cpu_tensor_takes_plain_and_counts_nothing():
    q, k, v, bias, mask = map(torch.from_numpy,
                              _inputs(np.random.default_rng(2), 2, 2, 128, 16, 2))
    before = twattn.window_attention.launches
    torch.testing.assert_close(twattn.window_attention(q, k, v, bias, mask, 0.25),
                               twattn.window_attention_plain(q, k, v, bias, mask, 0.25),
                               rtol=0, atol=0)
    assert twattn.window_attention.launches == before


def test_seam_rule_is_jax_rule_without_backend():
    """scp_tpu's rule within the core's limits (windows up to 512, head
    dims up to 256): past them the unfused path runs on every device."""
    for w, hd in ((128, 8), (512, 64), (256, 16), (64, 64), (192, 64), (512, 12),
                  (384, 256), (128, 264), (1024, 64), (512, 48)):
        want = w >= 128 and w % 128 == 0 and hd % 8 == 0 and w <= 512 and hd <= 256
        assert twattn.supported(w, hd) is want


@pytest.mark.parametrize("hd", [8, 24, 48, 128])
def test_plain_matches_pallas_f32_at_every_head_dim(hd):
    """Head dims the core pads (8, 24, 48) or chunks (128), f32 as
    tests/test_pallas_attn.py runs the Pallas kernel."""
    q, k, v, bias, mask = _inputs(np.random.default_rng(hd), 5, 2, 128, hd, 2)
    want = pallas_attn._fused_fwd_impl(*map(jnp.asarray, (q, k, v, bias, mask)), hd ** -0.5,
                                       interpret=True)
    got = twattn.window_attention_plain(*map(torch.from_numpy, (q, k, v, bias, mask)),
                                        hd ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_no_mask_is_the_zero_mask():
    """The seams pass None where scp_tpu passes a (1, W, W) zero mask;
    adding 0.0 changes no logit, so both give the same bits."""
    q, k, v, bias, _ = map(torch.from_numpy, _inputs(np.random.default_rng(4), 3, 2, 128, 32, 1))
    zero = torch.zeros(1, 128, 128)
    torch.testing.assert_close(twattn.window_attention(q, k, v, bias, None, 0.2),
                               twattn.window_attention(q, k, v, bias, zero, 0.2),
                               rtol=0, atol=0)


@pytest.mark.parametrize("n", [512, 300])
def test_swin_encoder_with_switch_matches_jax(monkeypatch, n):
    """Both encoders with the switch on: window 128, head dim 32; n = 512
    tiles the window (whole windows), n = 300 pads every stage.  JAX's
    kernel runs in interpret mode with its backend test dropped."""
    from scp_tpu.models.swin1d import SwinConfig, SwinEncoder1D as JEnc
    from scp_tpu_torch.models.swin1d import SwinEncoder1D as TEnc

    cfg = SwinConfig(embed_dim=64, depths=(2, 1), num_heads=2, window_size=128,
                     mlp_ratio=2.0)
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, n, 64)).astype(np.float32)
    enc = JEnc(cfg)
    variables = jax.tree_util.tree_map(np.asarray, enc.init(jax.random.PRNGKey(0), x))
    variables = jax.tree_util.tree_map(
        lambda a: (a + rng.normal(0, 0.05, a.shape)).astype(np.float32), variables)

    calls = {"jax": 0, "port": 0}
    orig = pallas_attn._fused_fwd_impl

    def jax_kernel(*a, **kw):
        calls["jax"] += 1
        return orig(*a, interpret=True)

    monkeypatch.setattr(pallas_attn, "supported", twattn.supported)
    monkeypatch.setattr(pallas_attn, "_fused_fwd_impl", jax_kernel)
    monkeypatch.setenv("SCP_PALLAS_ATTN", "1")
    want = enc.apply(variables, jnp.asarray(x))

    from scp_tpu_torch import weights

    port_op = twattn.window_attention

    def port_kernel(*a):
        calls["port"] += 1
        return port_op(*a)

    monkeypatch.setattr(twattn, "window_attention", port_kernel)
    tenc = TEnc(64, 64, (2, 1), 2, 128, 2.0, pallas_attn=True)
    weights.load_into(tenc, unfreeze(variables))
    with torch.no_grad():
        got = tenc(torch.from_numpy(x))
    assert calls == {"jax": 3, "port": 3}  # every block took the fused attention
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4, rtol=2e-4)
