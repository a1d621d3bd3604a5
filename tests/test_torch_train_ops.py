"""The training seams of the port against the JAX package, on the CPU in f32:
the autograd Functions of kernels A, B, C and E give the gradients of
scp_tpu's custom_vjps (jax.vjp of the plain XLA references) and equal
direct autograd of the port's plain versions bit for bit; the fused
train-mode EdgeConv gives scp_tpu.ops.edgeconv_fused's outputs,
statistics and gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scp_tpu.ops import edgeconv_fused as jedge
from scp_tpu.ops import pallas_attn, pallas_mlp, pallas_swin
from scp_tpu_torch.ops import edgeconv_fused as tedge
from scp_tpu_torch.ops import mlp as tmlp
from scp_tpu_torch.ops import swin_attn as tswin
from scp_tpu_torch.ops import window_attn as twattn

TOL = 1e-4  # f32 on both sides, sums in other orders (PERF.md section 2's f32 rule)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _port_grads(fn, args, diff, g, plain=True):
    """fn.apply(*args, plain) and the gradients of <out, g> w.r.t. args[diff]."""
    leaves = [_t(a).requires_grad_(True) if i in diff else a for i, a in enumerate(args)]
    out = fn.apply(*leaves, plain)
    out.backward(_t(g))
    return out.detach(), [leaves[i].grad for i in diff]


def _direct_grads(plain_fn, args, diff, g):
    leaves = [_t(a).requires_grad_(True) if i in diff else a for i, a in enumerate(args)]
    out = plain_fn(*leaves)
    out.backward(_t(g))
    return out.detach(), [leaves[i].grad for i in diff]


def _close(got, want, transpose=False):
    w = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.numpy(), w.T if transpose else w, atol=TOL, rtol=TOL)


def _check_against_jax(fn, plain_fn, jax_ref, args, jargs, diff, transposed, g):
    out, grads = _port_grads(fn, args, diff, g, plain=False)
    want_out, vjp = jax.vjp(jax_ref, *[jargs[i] for i in diff])
    want = vjp(jnp.asarray(g))
    _close(out, want_out)
    for got, w, tr in zip(grads, want, transposed):
        _close(got, w, tr)
    # the Function's backward is autograd of the plain version: bit for bit
    out2, direct = _direct_grads(plain_fn, args, diff, g)
    assert torch.equal(out, out2)
    for a, b in zip(grads, direct):
        assert torch.equal(a, b)


def test_function_a_matches_jax_custom_vjp(rng):
    m, c, f = 96, 64, 128
    x = rng.normal(0, 1, (m, c)).astype(np.float32)
    scale, bias = rng.normal(1, .1, c).astype(np.float32), rng.normal(0, .1, c).astype(np.float32)
    w1, b1 = rng.normal(0, .1, (c, f)).astype(np.float32), rng.normal(0, .1, f).astype(np.float32)
    w2, b2 = rng.normal(0, .1, (f, c)).astype(np.float32), rng.normal(0, .1, c).astype(np.float32)
    g = rng.normal(0, 1, (m, c)).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (x, scale, bias, w1, b1, w2, b2)]
    targs = (x, scale, bias, w1.T, b1, w2.T, b2, 1e-5, "gelu")
    _check_against_jax(
        tmlp.LnMlpResidual,
        tmlp.ln_mlp_residual_plain,
        lambda *a: pallas_mlp._reference(*a, 1e-5, "gelu"),
        targs, jargs, range(7), [False, False, False, True, False, True, False], g)


def _shift_mask(n_masks, w, rng):
    return np.where(rng.random((n_masks, w, w)) > 0.7, -100.0, 0.0).astype(np.float32)


@pytest.mark.parametrize("n_masks", [0, 2])
def test_functions_b_c_match_jax_custom_vjps(rng, n_masks):
    bn, w, c, heads = 4, 64, 128, 4
    f32 = np.float32
    x, qs = rng.normal(0, 1, (bn, w, c)).astype(f32), rng.normal(0, 1, (bn, w, c)).astype(f32)
    scale, bias = rng.normal(1, .1, c).astype(f32), rng.normal(0, .1, c).astype(f32)
    rel = rng.normal(0, .5, (heads, w, w)).astype(f32)
    mask = _shift_mask(n_masks, w, rng) if n_masks else None
    jmask = jnp.asarray(mask if n_masks else np.zeros((1, w, w), f32))
    tmask = None if mask is None else _t(mask)
    wqkv, bqkv = rng.normal(0, .1, (c, 3 * c)).astype(f32), rng.normal(0, .1, 3 * c).astype(f32)
    wq, bq = rng.normal(0, .1, (c, c)).astype(f32), rng.normal(0, .1, c).astype(f32)
    wkv, bkv = rng.normal(0, .1, (c, 2 * c)).astype(f32), rng.normal(0, .1, 2 * c).astype(f32)
    wp, bp = rng.normal(0, .1, (c, c)).astype(f32), rng.normal(0, .1, c).astype(f32)
    g = rng.normal(0, 1, (bn, w, c)).astype(f32)

    # self: differentiable x, scale, bias, wqkv, bqkv, rel_bias, wp, bp (the mask is constant)
    jfixed = [jnp.asarray(a) for a in (x, scale, bias, wqkv, bqkv, rel)] + [jmask] + [
        jnp.asarray(wp), jnp.asarray(bp)]
    diff = [0, 1, 2, 3, 4, 5, 7, 8]

    def jself(*d):
        a = list(jfixed)
        for i, v in zip(diff, d):
            a[i] = v
        return pallas_swin._reference_self(*a, heads, 1e-5)

    targs = (x, scale, bias, wqkv.T, bqkv, rel, tmask, wp.T, bp, heads, 1e-5)
    _check_against_jax(tswin.AttnSublayerSelf,
                       tswin.attn_sublayer_self_plain,
                       jself, targs, jfixed, diff,
                       [False, False, False, True, False, False, True, False], g)

    jfixed = [jnp.asarray(a) for a in (x, qs, scale, bias, wq, bq, wkv, bkv, rel)] + [jmask] + [
        jnp.asarray(wp), jnp.asarray(bp)]
    diff = [0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 11]

    def jcross(*d):
        a = list(jfixed)
        for i, v in zip(diff, d):
            a[i] = v
        return pallas_swin._reference_cross(*a, heads, 1e-5)

    targs = (x, qs, scale, bias, wq.T, bq, wkv.T, bkv, rel, tmask, wp.T, bp, heads, 1e-5)
    _check_against_jax(tswin.AttnSublayerCross,
                       tswin.attn_sublayer_cross_plain,
                       jcross, targs, jfixed, diff,
                       [False, False, False, False, True, False, True, False, False, True,
                        False], g)


@pytest.mark.parametrize("n_masks", [0, 3])
def test_function_e_matches_jax_custom_vjp(rng, n_masks):
    bn, h, w, hd = 3, 2, 128, 16
    f32 = np.float32
    q, k, v = (rng.normal(0, 1, (bn, h, w, hd)).astype(f32) for _ in range(3))
    bias = rng.normal(0, .5, (h, w, w)).astype(f32)
    mask = _shift_mask(n_masks, w, rng) if n_masks else None
    jmask = jnp.asarray(mask if n_masks else np.zeros((1, w, w), f32))
    g = rng.normal(0, 1, (bn, h, w, hd)).astype(f32)
    scale = 0.25
    jargs = [jnp.asarray(a) for a in (q, k, v, bias)]
    targs = (q, k, v, bias, None if mask is None else _t(mask), scale)
    _check_against_jax(
        twattn.WindowAttention,
        twattn.window_attention_plain,
        lambda *a: pallas_attn._reference(*a, jmask, scale),
        targs, jargs, range(4), [False] * 4, g)


def test_functions_take_the_dispatching_op_unless_plain(monkeypatch):
    """plain=False calls the dispatching op (the kernel on a card, the
    plain version on the CPU); plain=True the plain version on any device."""
    calls = []
    real = tmlp.ln_mlp_residual

    def spy(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(tmlp, "ln_mlp_residual", spy)
    x = torch.randn(8, 64, requires_grad=True)
    args = (torch.ones(64), torch.zeros(64), torch.randn(128, 64), torch.zeros(128),
            torch.randn(64, 128), torch.zeros(64), 1e-5, "gelu")
    tmlp.LnMlpResidual.apply(x, *args, False).sum().backward()
    assert calls == [1] and x.grad is not None
    tmlp.LnMlpResidual.apply(x, *args, True)
    assert calls == [1]


# ---- the fused train-mode EdgeConv ------------------------------------------


def _edge_inputs(seed, b=2, n=64, f=16, k=5, neg_scale=True):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((b, n, f)).astype(np.float32)
    bc = rng.standard_normal((b, n, f)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, f).astype(np.float32)
    if neg_scale:  # the min branch
        scale[::3] *= -1.0
    bias = rng.standard_normal(f).astype(np.float32)
    idx = rng.integers(0, n, (b, n, k)).astype(np.int32)
    return a, bc, scale, bias, idx


@pytest.mark.parametrize("neg_scale", [True, False])
def test_edgeconv_fused_matches_jax_forward_stats_and_grads(neg_scale):
    a, bc, scale, bias, idx = _edge_inputs(1, neg_scale=neg_scale)
    w = np.random.default_rng(9).standard_normal(a.shape).astype(np.float32)

    def jloss(a_, bc_, s_, b_):
        out, _, _ = jedge.edgeconv_train_fused(a_, bc_, s_, b_, idx)
        return jnp.sum(out * w)

    jout, jmean, jvar = jedge.edgeconv_train_fused(a, bc, scale, bias, idx)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(a, bc, scale, bias)

    leaves = [_t(x).requires_grad_(True) for x in (a, bc, scale, bias)]
    out, mean, var = tedge.edgeconv_train_fused(*leaves, torch.from_numpy(idx).long())
    assert not mean.requires_grad and not var.requires_grad  # the declared stop-gradient
    (out * _t(w)).sum().backward()
    _close(out.detach(), jout)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-5, atol=1e-6)
    for leaf, want in zip(leaves, jgrads):
        _close(leaf.grad, want)


def test_edgeconv_fused_grad_routes_to_the_winners_only():
    """da lands on the winning neighbor rows only (tests/test_edgeconv_fused.py:82's
    property), and equals JAX's."""
    a, bc, scale, bias, idx = _edge_inputs(2, b=1, n=8, f=4, k=3, neg_scale=False)

    def jloss(a_):
        out, _, _ = jedge.edgeconv_train_fused(a_, bc, scale, bias, idx)
        return jnp.sum(out)

    ta = _t(a).requires_grad_(True)
    out, _, _ = tedge.edgeconv_train_fused(ta, _t(bc), _t(scale), _t(bias),
                                           torch.from_numpy(idx).long())
    out.sum().backward()
    _close(ta.grad, jax.grad(jloss)(a))
    winners = np.zeros_like(a, bool)
    gathered = a[0][idx[0]]  # (n, k, f)
    arg = gathered.argmax(1)  # scale > 0: the max wins
    for i in range(a.shape[1]):
        for c in range(a.shape[2]):
            winners[0, idx[0, i, arg[i, c]], c] = True
    assert not ta.grad.numpy()[~winners].any()
    assert ta.grad.numpy()[winners].all()


def test_batchnorm_train_update_is_flax_momentum_and_biased_var():
    """ra = 0.9 ra + 0.1 batch, biased variance (torch.nn.BatchNorm1d would
    keep 0.9 of the batch and the unbiased variance)."""
    from scp_tpu_torch.models.dgcnn import BatchNorm, batch_stats

    bn = BatchNorm(3)
    x = torch.randn(50, 3)
    mean, var = batch_stats(x, 0)
    bn.update(mean, var)
    torch.testing.assert_close(bn.running_mean, 0.1 * x.mean(0), atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * x.var(0, unbiased=False),
                               atol=1e-6, rtol=1e-5)


def test_kernel_d_takes_no_gradient():
    """D's output is integer (no VJP in scp_tpu either): features that need
    a gradient are refused, and the model builds its graphs from detached
    features, so the graph of a training forward is the codec's graph."""
    from scp_tpu_torch.ops import knn_topk as tknn

    feats = torch.rand(1, 64, 3, requires_grad=True)
    with pytest.raises(ValueError, match="gradient"):
        tknn.knn_topk(feats, 4)
    assert torch.equal(tknn.knn_topk(feats.detach(), 4), tknn.knn_topk_plain(feats.detach(), 4))
    with torch.no_grad():
        tknn.knn_topk(feats, 4)
