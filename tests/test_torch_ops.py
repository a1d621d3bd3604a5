"""Port ops vs the JAX package: the plain versions of kernels A, B and C
against the Pallas kernels (interpret mode, as tests/test_pallas_*.py run
them, same small shapes and atol=rtol=3e-2), and the KNN ops against
scp_tpu.ops.knn.  The CUDA kernels themselves are held against the plain
versions in tests/test_torch_kernels.py, on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scp_tpu.ops import knn as jknn
from scp_tpu.ops import pallas_mlp, pallas_swin
from scp_tpu_torch.ops import knn as tknn
from scp_tpu_torch.ops import mlp as tmlp
from scp_tpu_torch.ops import swin_attn as tswin

TOL = 3e-2  # the Pallas tests' own bf16 tolerance


def _t(a, dtype=None):
    """numpy/jax array -> torch tensor (bf16 goes through f32: exact)."""
    a = np.asarray(jnp.asarray(a, jnp.float32) if dtype is torch.bfloat16 else a)
    t = torch.from_numpy(np.array(a))
    return t.to(dtype) if dtype is not None else t


def _close(got, want):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=TOL, rtol=TOL
    )


# ---- kernel A: LN + MLP + residual -----------------------------------------


@pytest.mark.parametrize("act", ["gelu", "leaky"])
def test_mlp_plain_matches_pallas(rng, act):
    m, c, f = 2 * pallas_mlp._TILE, 256, 1024
    x = jnp.asarray(rng.normal(0.0, 1.0, (m, c)), jnp.bfloat16)
    scale = jnp.asarray(rng.normal(1.0, 0.1, c), jnp.float32)
    bias = jnp.asarray(rng.normal(0.0, 0.1, c), jnp.float32)
    w1 = jnp.asarray(rng.normal(0.0, 0.05, (c, f)), jnp.bfloat16)
    b1 = jnp.asarray(rng.normal(0.0, 0.05, f), jnp.float32)
    w2 = jnp.asarray(rng.normal(0.0, 0.05, (f, c)), jnp.bfloat16)
    b2 = jnp.asarray(rng.normal(0.0, 0.05, c), jnp.float32)
    want = pallas_mlp._fused_impl(x, scale, bias, w1, b1, w2, b2, 1e-5, act,
                                  interpret=True)
    bf = torch.bfloat16
    got = tmlp.ln_mlp_residual(
        _t(x, bf), _t(scale), _t(bias), _t(w1, bf).T.contiguous(), _t(b1),
        _t(w2, bf).T.contiguous(), _t(b2), 1e-5, act,
    )
    assert got.dtype == bf and got.shape == (m, c)
    _close(got, want)


# ---- kernels B and C: attention sublayers ------------------------------------


def _mk(rng, bn, w, c, heads, n_masks):
    x = jnp.asarray(rng.normal(0, 1, (bn, w, c)), jnp.bfloat16)
    scale = jnp.asarray(rng.normal(1, 0.1, c), jnp.float32)
    bias = jnp.asarray(rng.normal(0, 0.1, c), jnp.float32)
    rel = jnp.asarray(rng.normal(0, 0.2, (heads, w, w)), jnp.float32)
    mask = jnp.asarray(
        np.where(rng.random((n_masks, w, w)) < 0.1, -100.0, 0.0), jnp.float32
    )
    wp = jnp.asarray(rng.normal(0, 0.05, (c, c)), jnp.bfloat16)
    bp = jnp.asarray(rng.normal(0, 0.05, c), jnp.float32)
    return x, scale, bias, rel, mask, wp, bp


@pytest.mark.parametrize("n_masks", [1, 2])
def test_self_attn_plain_matches_pallas(rng, n_masks):
    bn, w, c, h = 3, 128, 128, 4
    x, scale, bias, rel, mask, wp, bp = _mk(rng, bn, w, c, h, n_masks)
    wqkv = jnp.asarray(rng.normal(0, 0.05, (c, 3 * c)), jnp.bfloat16)
    bqkv = jnp.asarray(rng.normal(0, 0.05, 3 * c), jnp.float32)
    want = pallas_swin._self_impl(x, scale, bias, wqkv, bqkv, rel, mask, wp, bp, h,
                                  1e-5, interpret=True)
    bf = torch.bfloat16
    got = tswin.attn_sublayer_self(
        _t(x, bf), _t(scale), _t(bias), _t(wqkv, bf).T.contiguous(), _t(bqkv),
        _t(rel), _t(mask), _t(wp, bf).T.contiguous(), _t(bp), h, 1e-5,
    )
    assert got.dtype == bf and got.shape == (bn, w, c)
    _close(got, want)


def test_cross_attn_plain_matches_pallas(rng):
    bn, w, c, h = 2, 128, 128, 4
    x, scale, bias, rel, mask, wp, bp = _mk(rng, bn, w, c, h, 1)
    qs = jnp.asarray(rng.normal(0, 1, (bn, w, c)), jnp.bfloat16)
    wq = jnp.asarray(rng.normal(0, 0.05, (c, c)), jnp.bfloat16)
    bq = jnp.asarray(rng.normal(0, 0.05, c), jnp.float32)
    wkv = jnp.asarray(rng.normal(0, 0.05, (c, 2 * c)), jnp.bfloat16)
    bkv = jnp.asarray(rng.normal(0, 0.05, 2 * c), jnp.float32)
    want = pallas_swin._cross_impl(x, qs, scale, bias, wq, bq, wkv, bkv, rel, mask,
                                   wp, bp, h, 1e-5, interpret=True)
    bf = torch.bfloat16
    got = tswin.attn_sublayer_cross(
        _t(x, bf), _t(qs, bf), _t(scale), _t(bias), _t(wq, bf).T.contiguous(),
        _t(bq), _t(wkv, bf).T.contiguous(), _t(bkv), _t(rel), _t(mask),
        _t(wp, bf).T.contiguous(), _t(bp), h, 1e-5,
    )
    _close(got, want)


def test_cpu_tensors_take_the_plain_versions_and_count_nothing(rng):
    """On a CPU tensor the wrappers return exactly the plain version and
    never touch the kernel launch counters."""
    before = (tmlp.ln_mlp_residual.launches, tswin.attn_sublayer_self.launches,
              tswin.attn_sublayer_cross.launches)
    c, f = 64, 128
    x = torch.randn(64, c)
    p = [torch.randn(c), torch.randn(c), torch.randn(f, c), torch.randn(f),
         torch.randn(c, f), torch.randn(c)]
    torch.testing.assert_close(
        tmlp.ln_mlp_residual(x, *p, 1e-5, "gelu"),
        tmlp.ln_mlp_residual_plain(x, *p, 1e-5, "gelu"), rtol=0, atol=0,
    )
    after = (tmlp.ln_mlp_residual.launches, tswin.attn_sublayer_self.launches,
             tswin.attn_sublayer_cross.launches)
    assert after == before


def test_seam_rules_are_device_independent():
    assert tswin.supported(1024, 512, 256, 4)
    assert not tswin.supported(1000, 512, 256, 4)  # padded: unfused path
    assert not tswin.supported(1024, 512, 64, 4)  # C not a multiple of 128
    assert tmlp.supported(256, 1024) and not tmlp.supported(48, 96)
    # scp_tpu's rule (pallas_swin.supported) without its backend test, at
    # windows of 64-row tiles up to the core's 512 and head dims up to 256
    for n, w, c, h in ((1024, 512, 256, 8), (1024, 512, 128, 4), (512, 64, 384, 8),
                       (2048, 1024, 256, 4), (1024, 512, 512, 1), (1024, 512, 256, 3),
                       (1024, 512, 384, 16), (192, 96, 256, 4)):
        want = (n % w == 0 and c % 128 == 0 and c % h == 0 and (c // h) % 8 == 0
                and w % 64 == 0 and w <= 512 and c // h <= 256)
        assert tswin.supported(n, w, c, h) is want, (n, w, c, h)


# ---- B and C's plain versions in f32 at head dim 32 ---------------------------

F32_TOL = 2e-5


@pytest.mark.parametrize("n_masks", [0, 1, 3])
def test_self_and_cross_plain_match_jax_reference_f32_hd32(rng, n_masks):
    """The plain versions against pallas_swin._reference_self / _cross
    (their custom_vjp recompute path) in f32 at head dim 32; no mask (the
    seam's unshifted call) against JAX's zero mask."""
    bn, w, c, h = 3, 128, 128, 4
    f32 = jnp.float32
    x = jnp.asarray(rng.normal(0, 1, (bn, w, c)), f32)
    qs = jnp.asarray(rng.normal(0, 1, (bn, w, c)), f32)
    scale = jnp.asarray(rng.normal(1, 0.1, c), f32)
    bias = jnp.asarray(rng.normal(0, 0.1, c), f32)
    rel = jnp.asarray(rng.normal(0, 0.2, (h, w, w)), f32)
    mask = np.where(rng.random((max(n_masks, 1), w, w)) < 0.1, -100.0, 0.0).astype(np.float32)
    if n_masks == 0:
        mask[:] = 0.0
    jmask = jnp.asarray(mask)
    tmask = None if n_masks == 0 else _t(mask)
    wqkv, wq, wkv, wp = (jnp.asarray(rng.normal(0, 0.05, (c, k * c)), f32) for k in (3, 1, 2, 1))
    bqkv, bq, bkv, bp = (jnp.asarray(rng.normal(0, 0.05, k * c), f32) for k in (3, 1, 2, 1))

    def lin(wt):
        return _t(wt).T.contiguous()

    want = pallas_swin._reference_self(x, scale, bias, wqkv, bqkv, rel, jmask, wp, bp, h, 1e-5)
    got = tswin.attn_sublayer_self(_t(x), _t(scale), _t(bias), lin(wqkv), _t(bqkv), _t(rel),
                                   tmask, lin(wp), _t(bp), h, 1e-5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)
    want = pallas_swin._reference_cross(x, qs, scale, bias, wq, bq, wkv, bkv, rel, jmask, wp,
                                        bp, h, 1e-5)
    got = tswin.attn_sublayer_cross(_t(x), _t(qs), _t(scale), _t(bias), lin(wq), _t(bq),
                                    lin(wkv), _t(bkv), _t(rel), tmask, lin(wp), _t(bp), h, 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)


# ---- KNN ----------------------------------------------------------------------


@pytest.mark.parametrize("n,k", [(200, 8), (1500, 20)])
def test_knn_indices_match_jax_on_tie_free_inputs(rng, n, k):
    """Continuous random features have no tied distances; the chunked
    path (n > 1024) is exercised too."""
    feats = rng.normal(size=(2, n, 5)).astype(np.float32)
    want = np.asarray(jknn.knn_indices(jnp.asarray(feats), k))
    got = tknn.knn_indices(torch.from_numpy(feats), k)
    np.testing.assert_array_equal(got.numpy(), want)


def test_knn_ties_go_to_the_lowest_index():
    """Duplicate points tie exactly; lax.top_k's order (and the Pallas
    kernel's _argmax_cols) puts the lower index first."""
    pts = np.zeros((1, 6, 3), np.float32)
    pts[0, 3:] = 1.0  # two clusters of three identical points
    got = tknn.knn_indices(torch.from_numpy(pts), 4).numpy()
    want = np.asarray(jknn.knn_indices(jnp.asarray(pts), 4))
    np.testing.assert_array_equal(got, want)
    assert got[0, 4].tolist() == [3, 4, 5, 0]


def test_gather_and_max_over_neighbors_match_jax(rng):
    feats = rng.normal(size=(2, 50, 7)).astype(np.float32)
    idx = rng.integers(0, 50, size=(2, 50, 6)).astype(np.int32)
    tf, ti = torch.from_numpy(feats), torch.from_numpy(idx).long()
    np.testing.assert_array_equal(
        tknn.gather_neighbors(tf, ti).numpy(),
        np.asarray(jknn.gather_neighbors(jnp.asarray(feats), jnp.asarray(idx))),
    )
    np.testing.assert_array_equal(
        tknn.max_over_neighbors(tf, ti).numpy(),
        np.asarray(jknn.max_over_neighbors(jnp.asarray(feats), jnp.asarray(idx))),
    )
