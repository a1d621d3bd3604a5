"""The EHEM configuration with both fused-kernel switches on (the port's
pallas_knn / pallas_attn arguments; scp_tpu's SCP_PALLAS_KNN=1 and
SCP_PALLAS_ATTN=1) against JAX on the CPU, and the codec in that
configuration.  JAX's dispatch asks for a non-CPU backend before it takes
its Pallas kernels; here that test alone is dropped (monkeypatched) and
the kernels run in interpret mode, so both packages take kernels D and E
at the same seams."""

import functools
import os

import jax
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from scp_tpu.models import dgcnn as jdgcnn
from scp_tpu.models.ehem import EHEM as JEHEM
from scp_tpu.ops import knn as jknn
from scp_tpu.ops import pallas_attn, pallas_knn
from scp_tpu_torch import weights
from scp_tpu_torch.codec import ehem_codec as tcodec
from scp_tpu_torch.models.ehem import EHEM as TEHEM
from scp_tpu_torch.ops import knn_topk as tknn_topk
from scp_tpu_torch.ops import window_attn as twattn
from test_torch_models import LOGIT_TOL, random_context

# window 128 so E engages; N = 2048 so D does
CFG = dict(self_depths=(2, 2), cross_depths=(2, 1), embed_dim=64, num_heads=4,
           window_size=128, mlp_ratio=2.0, knn_k=4)


@pytest.fixture
def jax_kernels_on_cpu(monkeypatch):
    """JAX's two switches on, each dispatch without its backend test and
    its kernel in interpret mode; counts the kernel calls of both sides."""
    calls = {"jax_knn": 0, "jax_attn": 0, "knn": 0, "attn": 0}

    def jax_knn(feats, k):
        if os.environ.get("SCP_PALLAS_KNN") and feats.shape[1] >= 2048:
            calls["jax_knn"] += 1
            return pallas_knn.knn_pallas(feats, k, interpret=True)
        return jknn._knn_xla(feats, k)

    orig_attn = pallas_attn._fused_fwd_impl

    def jax_attn(*a, **kw):
        calls["jax_attn"] += 1
        return orig_attn(*a, interpret=True)

    monkeypatch.setenv("SCP_STATIC_KNN", "1")  # never "0": JAX reads these with bool()
    monkeypatch.setenv("SCP_PALLAS_KNN", "1")
    monkeypatch.setenv("SCP_PALLAS_ATTN", "1")
    monkeypatch.setattr(jdgcnn, "knn_indices", jax_knn)
    monkeypatch.setattr(pallas_attn, "supported", twattn.supported)
    monkeypatch.setattr(pallas_attn, "_fused_fwd_impl", jax_attn)

    port_knn, port_attn = tknn_topk.knn_topk, twattn.window_attention

    def count(key, fn):
        def wrapped(*a):
            calls[key] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(tknn_topk, "knn_topk", count("knn", port_knn))
    monkeypatch.setattr(twattn, "window_attention", count("attn", port_attn))
    return calls


def random_variables(rng, model):
    """Every leaf drawn from the numpy rng at flax's shapes (eval_shape,
    so no eager init runs): kernels ~ N(0, 1/fan_in), norm scales and
    running variances near 1, everything else ~ N(0, 0.2)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            np.zeros((1, 8, 4, 3), np.int32), np.zeros((1, 8, 3), np.float32))

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            v = rng.normal(0.0, 1.0 / np.sqrt(s.shape[0]), s.shape)
        elif name in ("var", "scale"):
            v = 1.0 + np.abs(rng.normal(0.0, 0.2, s.shape))
        else:
            v = rng.normal(0.0, 0.2, s.shape)
        return v.astype(np.float32)

    return unfreeze(jax.tree_util.tree_map_with_path(leaf, shapes))


def _phases(jm, variables, data, pos, occ):
    """JAX's phase-1 logits and features and phase-2 logits, jitted (the
    kernels' interpret mode and the switches are read while tracing)."""
    p1 = jax.jit(functools.partial(jm.apply, method=JEHEM.decode_phase1))
    p2 = jax.jit(functools.partial(jm.apply, method=JEHEM.decode_phase2),
                 static_argnums=4)
    l1, f1, f2 = p1(variables, data, pos)
    return l1, f1, p2(variables, f1, f2, occ, False)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_switches_are_arguments_threaded_to_every_seam():
    m = TEHEM(**CFG, static_knn=True, pallas_knn=True, pallas_attn=True, device="cpu")
    assert m.geo.pallas_knn and m.pallas_knn and m.pallas_attn
    attn = [mod for mod in m.modules() if hasattr(mod, "pallas_attn") and mod is not m]
    assert len(attn) == 2 * 2 + 2 + 1 and all(a.pallas_attn for a in attn)
    off = TEHEM(**CFG, static_knn=True, device="cpu")
    assert not off.geo.pallas_knn
    assert not any(getattr(mod, "pallas_attn", False) for mod in off.modules())


def test_narrow_ehem_with_both_switches_matches_jax(jax_kernels_on_cpu):
    rng = np.random.default_rng(17)
    jm = JEHEM(**CFG)
    variables = random_variables(rng, jm)
    tm = weights.load_into(TEHEM(**CFG, static_knn=True, pallas_knn=True, pallas_attn=True,
                                 device="cpu"), variables)
    data, pos = random_context(rng, 1, 2048)
    occ = rng.integers(0, 255, (1, 1024)).astype(np.int32)
    l1, f1, l2 = _phases(jm, variables, data, pos, occ)
    t1, tf1, tf2 = tm.decode_phase1(torch.from_numpy(data), torch.from_numpy(pos))
    t2 = tm.decode_phase2(tf1, tf2, torch.from_numpy(occ), False)
    _close(t1, l1)
    _close(tf1, f1)
    _close(t2, l2)
    calls = jax_kernels_on_cpu
    # D once (the static graph).  The port's E: the blocks off the fused
    # B/C seam (head dim 16: self stage 1, cross stage 1); JAX runs every
    # block unfused on the CPU
    assert calls["jax_knn"] == calls["knn"] == 1
    assert calls["attn"] == 3 and calls["jax_attn"] >= 7


def test_f32_ehem_with_attention_switch_at_head_dim_48_matches_jax(jax_kernels_on_cpu):
    """EHEM(dtype=float32, pallas_attn=True) against JAX f32 with
    SCP_PALLAS_ATTN=1: stage 0 (C = 256, head dim 64) takes the fused B/C
    seam in the port, the 192-wide stages (head dim 48, which the earlier
    two-pass kernel refused) take E on both sides."""
    cfg = dict(CFG, embed_dim=192)
    rng = np.random.default_rng(23)
    jm = JEHEM(**cfg)
    variables = random_variables(rng, jm)
    tm = weights.load_into(TEHEM(**cfg, static_knn=True, pallas_attn=True, device="cpu"),
                           variables)
    assert tm.dtype == torch.float32
    data, pos = random_context(rng, 1, 512)
    occ = rng.integers(0, 255, (1, 256)).astype(np.int32)
    l1, f1, l2 = _phases(jm, variables, data, pos, occ)
    t1, tf1, tf2 = tm.decode_phase1(torch.from_numpy(data), torch.from_numpy(pos))
    t2 = tm.decode_phase2(tf1, tf2, torch.from_numpy(occ), False)
    _close(t1, l1)
    _close(tf1, f1)
    _close(t2, l2)
    calls = jax_kernels_on_cpu
    # the port's E: self stage 1 (2 blocks) and cross stage 1 (1 block);
    # JAX runs every block unfused on the CPU, so E at all 7 (per trace)
    assert calls["attn"] == 3 and calls["jax_attn"] >= 7
    assert calls["knn"] == calls["jax_knn"] == 0  # 512 rows: under D's threshold


def test_full_width_checkpoint_with_both_switches_matches_jax(jax_kernels_on_cpu):
    """ehem_synth_f16_sknn.npz on a 2048-node context of the bench-like
    cloud, as test_torch_models.py::test_full_width_checkpoint_logits_match_jax,
    with D on the position graph and E on the padded deep stages."""
    from scp_tpu.train.checkpoints import load_params_npz
    from scp_tpu_torch.codec.slices import split_levels
    from scp_tpu_torch.core.preprocess import kitti_qs, preprocess_points

    ckpt = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                        "ehem_synth_f16_sknn.npz")
    rng = np.random.default_rng(0)
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

    l1, _, l2 = _phases(JEHEM(), load_params_npz(ckpt), d, p, occ[None, ::2])
    tm = weights.load_into(TEHEM(static_knn=True, pallas_knn=True, pallas_attn=True,
                                 device="cpu"), ckpt)
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
    calls = jax_kernels_on_cpu
    # port's E: phase 1's stages of 256 and 128 tokens (depths 4, 2) and
    # phase 2's (1, 1) pad the 512 window; whole windows keep B/C
    assert calls["jax_knn"] == calls["knn"] == 1
    assert calls["attn"] == 8 and calls["jax_attn"] >= 24


def test_codec_roundtrip_with_both_switches_is_lossless_and_stamped():
    from scp_tpu_torch.codec.slices import split_levels
    from scp_tpu_torch.core.preprocess import preprocess_points

    torch.manual_seed(0)
    kw = dict(**CFG, static_knn=True, device="cpu")
    tm = TEHEM(**kw, pallas_knn=True, pallas_attn=True)
    with torch.no_grad():
        for prm in tm.parameters():
            prm.normal_(0.0, 0.05)
    rng = np.random.default_rng(11)
    n = 1500
    r, az, el = rng.uniform(2, 60, n), rng.uniform(0, 2 * np.pi, n), rng.uniform(-0.4, 0.2, n)
    pts = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                    r * np.sin(el)], 1)
    sl = split_levels(preprocess_points(pts, system="spher", qs=60.0 / 255).context,
                      angular=True)
    assert max(sl.level_sizes) > 1024  # one (1, 2048) call: D engages

    calls = {"knn": 0}
    port_knn = tknn_topk.knn_topk

    def spy(*a):
        calls["knn"] += 1
        return port_knn(*a)

    codec = tcodec.EHEMCodec(tm, context_size=2048)
    stamp = codec.coding_params()
    assert "pallas_knn=1;pallas_attn=1" in stamp
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tknn_topk, "knn_topk", spy)
        stream, bits, _ = codec.encode_to_stream(sl)
        codes = codec.decode(codec.new_stream_decoder(stream, len(sl.occ_stream),
                                                     coding_params=stamp), sl.max_level,
                             np.array(sl.pos_mm), angular=True,
                             ground_truth=sl.occ_stream, level_sizes=sl.level_sizes)
    np.testing.assert_array_equal(codes, sl.occ_stream)
    assert bits > 0 and calls["knn"] > 0 and calls["knn"] % 2 == 0  # encode + decode

    off = TEHEM(**kw)
    off.load_state_dict(tm.state_dict())
    off_codec = tcodec.EHEMCodec(off, context_size=2048)
    assert "pallas_knn=0;pallas_attn=0" in off_codec.coding_params()
    with pytest.raises(ValueError, match="pallas_knn=1"):
        off_codec.new_stream_decoder(stream, len(sl.occ_stream), coding_params=stamp)
