"""Port models vs the JAX package, in f32 on the CPU: the EHEM logits of
both phases from the same numpy weights, at a small config whose stage-0
Swin blocks take the fused-sublayer seams in the port (head dim 64,
window 64) and whose later stages and padded sequences take the unfused
path.  JAX runs its own CPU path (exact top-k, XLA sublayers)."""

import jax
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from scp_tpu.models.ehem import EHEM as JEHEM
from scp_tpu_torch import weights
from scp_tpu_torch.models.ehem import EHEM as TEHEM

# f32 on both sides; the sums run in other orders (and flax's LayerNorm
# takes E[x^2] - E[x]^2), so logits agree to ~1e-5 relative; 2e-4 leaves
# a margin of about ten.
LOGIT_TOL = 2e-4

CFG = dict(self_depths=(2, 2), cross_depths=(2, 1), embed_dim=64, num_heads=4,
           window_size=64, mlp_ratio=2.0, knn_k=4)


def randomized_variables(rng, model, n=8):
    """flax init, then every leaf perturbed from the numpy rng (biases,
    norms, tables and statistics would otherwise sit at 0 or 1)."""
    d = np.zeros((1, n, 4, 3), np.int32)
    p = np.zeros((1, n, 3), np.float32)
    v = unfreeze(jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(0), d, p)))

    def walk(node):
        for k, val in node.items():
            if isinstance(val, dict):
                walk(val)
                continue
            noise = rng.normal(0.0, 0.05, val.shape).astype(np.float32)
            if k == "var":
                node[k] = (1.0 + np.abs(noise) * 4).astype(np.float32)
            elif k == "kernel":
                node[k] = (val + noise * 0.2).astype(np.float32)
            else:
                node[k] = (val + noise * 4).astype(np.float32)

    walk(v)
    return v


def random_context(rng, b, n, max_level=12):
    data = np.zeros((b, n, 4, 3), np.int32)
    data[..., 0] = rng.integers(1, max_level, (b, n, 4))
    data[..., 1] = rng.integers(1, 9, (b, n, 4))
    data[..., 2] = rng.integers(0, 255, (b, n, 4))
    data[:, :, 3, 2] = 255  # current occupancy unknown
    pos = rng.random((b, n, 3)).astype(np.float32)
    return data, pos


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(7)
    jm = JEHEM(**CFG)
    variables = randomized_variables(rng, jm)
    tm = TEHEM(**CFG, static_knn=True, device="cpu")
    weights.load_into(tm, variables)
    return jm, variables, tm


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("n", [256, 97])
def test_ehem_phase_logits_match_jax(pair, rng, monkeypatch, n):
    """n=256 tiles the window (fused seams at stage 0); n=97 is odd
    (pad node) and pads every stage (unfused path)."""
    monkeypatch.setenv("SCP_STATIC_KNN", "1")  # never "0": JAX reads it with bool()
    jm, variables, tm = pair
    data, pos = random_context(rng, 2, n)
    l1, f1, f2 = jm.apply(variables, data, pos, method=JEHEM.decode_phase1)
    t1, tf1, tf2 = tm.decode_phase1(torch.from_numpy(data), torch.from_numpy(pos))
    _close(t1, l1)
    _close(tf1, f1)
    occ = rng.integers(0, 255, (2, (n + 1) // 2)).astype(np.int32)
    l2 = jm.apply(variables, f1, f2, occ, n % 2 == 1, method=JEHEM.decode_phase2)
    t2 = tm.decode_phase2(tf1, tf2, torch.from_numpy(occ), n % 2 == 1)
    assert t2.shape == l2.shape
    _close(t2, l2)


def test_dynamic_knn_matches_jax(rng, monkeypatch):
    """static_knn=False recomputes the feature graphs, like JAX with
    SCP_STATIC_KNN unset."""
    monkeypatch.delenv("SCP_STATIC_KNN", raising=False)
    jm = JEHEM(**CFG)
    variables = randomized_variables(np.random.default_rng(3), jm)
    tm = weights.load_into(TEHEM(**CFG, static_knn=False, device="cpu"), variables)
    data, pos = random_context(rng, 1, 128)
    l1, _, _ = jm.apply(variables, data, pos, method=JEHEM.decode_phase1)
    t1, _, _ = tm.decode_phase1(torch.from_numpy(data), torch.from_numpy(pos))
    _close(t1, l1)


def test_static_knn_is_an_argument_not_a_string():
    """The port takes static KNN as a constructor argument, so the
    environment string "0" cannot switch it on (scp_tpu's bool() trap)."""
    m = TEHEM(**CFG, static_knn=False, device="cpu")
    assert m.geo.static_knn is False
    assert TEHEM(**CFG, static_knn=True, device="cpu").geo.static_knn is True


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TEHEM(**CFG)


def test_full_width_checkpoint_logits_match_jax(monkeypatch):
    """The trained full-width EHEM (ehem_synth_f16_sknn.npz, static KNN,
    C=256, window 512) on a 2048-node context of the bench-like cloud:
    both phases' logits and their code lengths agree with JAX's in f32."""
    import os

    from scp_tpu.train.checkpoints import load_params_npz
    from scp_tpu_torch.codec.slices import split_levels
    from scp_tpu_torch.core.preprocess import kitti_qs, preprocess_points

    monkeypatch.setenv("SCP_STATIC_KNN", "1")
    ckpt = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                        "ehem_synth_f16_sknn.npz")
    rng = np.random.default_rng(0)  # the bench cloud generator, 4000 points
    beams = 64
    el = np.deg2rad(np.linspace(-24.8, 2.0, beams))[rng.integers(0, beams, 4000)]
    az = rng.uniform(0, 2 * np.pi, 4000)
    r = np.clip(rng.gamma(3.0, 8.0, 4000) + 2.0, 2.0, 120.0)
    pts = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                    r * np.sin(el)], 1)
    sl = split_levels(preprocess_points(pts, system="spher", qs=kitti_qs(12)).context,
                      angular=True)
    li = int(np.argmax(sl.level_sizes))
    d = sl.data[li][:2048].copy()
    occ = d[:, 3, 2].copy()
    d[:, 3, 2] = 255
    d, p = d[None], sl.level_pos(li)[:2048][None]

    v = load_params_npz(ckpt)
    jm = JEHEM()
    l1, f1, f2 = jm.apply(v, d, p, method=JEHEM.decode_phase1)
    l2 = jm.apply(v, f1, f2, occ[None, ::2], False, method=JEHEM.decode_phase2)
    tm = weights.load_into(TEHEM(static_knn=True, device="cpu"), ckpt)
    t1, tf1, tf2 = tm.decode_phase1(torch.from_numpy(d), torch.from_numpy(p))
    t2 = tm.decode_phase2(tf1, tf2, torch.from_numpy(occ[None, ::2]), False)

    def bits(lg, s):
        x = lg - lg.max(-1, keepdims=True)
        lp = x - np.log(np.exp(x).sum(-1, keepdims=True))
        return -lp[np.arange(len(s)), s].sum() / np.log(2)

    for want, got, sym in ((l1, t1, occ[::2]), (l2, t2, occ[1::2])):
        _close(got, want)
        assert abs(bits(got[0].numpy(), sym) - bits(np.asarray(want)[0], sym)) <= (
            1e-5 * bits(np.asarray(want)[0], sym)
        )
