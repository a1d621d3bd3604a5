"""JAX's default EHEM, the dynamic graph (checkpoints/ehem_synth_f16.npz,
static KNN off: EdgeConv 2 and 3 rebuild their graphs on the C = 144 and
C = 192 features), at full width against JAX on the CPU, with the switches
off and with `pallas_knn` (kernel D builds all three graphs of a call of
N >= 2048 rows; its plain version here, Pallas in interpret mode in JAX).

Each graph is compared as well as the logits: a row where the two graphs
differ must be a near tie (the sorted exact distances of both picks agree
to f32 rounding), and the share of such rows is printed."""

import os

import numpy as np
import pytest
import torch

from scp_tpu.models import dgcnn as jdgcnn
from scp_tpu.models.ehem import EHEM as JEHEM
from scp_tpu_torch import weights
from scp_tpu_torch.models import dgcnn as tdgcnn
from scp_tpu_torch.models.ehem import EHEM as TEHEM
from test_torch_models import LOGIT_TOL
from test_torch_pallas_config import _phases, jax_kernels_on_cpu  # noqa: F401 (fixture)

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "ehem_synth_f16.npz")
GRAPH_RTOL = 1e-5  # sorted exact distances of two picks at a near tie


def bench_context(n=2048):
    """A 2048-node context of the bench-like cloud (4000 points, spherical
    L12), as tests/test_torch_pallas_config.py builds it."""
    from scp_tpu_torch.codec.slices import split_levels
    from scp_tpu_torch.core.preprocess import kitti_qs, preprocess_points

    rng = np.random.default_rng(0)
    el = np.deg2rad(np.linspace(-24.8, 2.0, 64))[rng.integers(0, 64, 4000)]
    az = rng.uniform(0, 2 * np.pi, 4000)
    r = np.clip(rng.gamma(3.0, 8.0, 4000) + 2.0, 2.0, 120.0)
    pts = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                    r * np.sin(el)], 1)
    sl = split_levels(preprocess_points(pts, system="spher", qs=kitti_qs(12)).context,
                      angular=True)
    li = int(np.argmax(sl.level_sizes))
    d = sl.data[li][:n].copy()
    occ = d[:, 3, 2].copy()
    d[:, 3, 2] = 255
    return d[None], sl.level_pos(li)[:n][None], occ


def _record_graphs(monkeypatch):
    """Wraps both packages' KNN seams of the DGCNN (JAX running eagerly);
    returns the lists they fill with (features, indices), in call order."""
    got = {"jax": [], "port": []}
    jax_inner, port_inner = jdgcnn.knn_indices, tdgcnn.knn_indices

    def jax_rec(feats, k):
        idx = jax_inner(feats, k)
        got["jax"].append((np.asarray(feats), np.asarray(idx)))
        return idx

    def port_rec(feats, k, *a):
        idx = port_inner(feats, k, *a)
        got["port"].append((feats.float().numpy(), idx.numpy()))
        return idx

    monkeypatch.setattr(jdgcnn, "knn_indices", jax_rec)
    monkeypatch.setattr(tdgcnn, "knn_indices", port_rec)
    return got


def _check_graphs(port, jax_graphs):
    """Each port graph against JAX's: rows that differ are near ties.
    Returns the share of differing rows per graph."""
    shares = []
    for (f, gi), (_, wi) in zip(port, jax_graphs):
        f = f[0].astype(np.float64)
        gi, wi = gi[0], wi[0].astype(np.int64)
        rows = np.nonzero((gi != wi).any(-1))[0]
        shares.append(len(rows) / len(gi))
        for i in rows:
            dg = np.sort(((f[gi[i]] - f[i]) ** 2).sum(-1))
            dw = np.sort(((f[wi[i]] - f[i]) ** 2).sum(-1))
            np.testing.assert_allclose(dg, dw, rtol=GRAPH_RTOL, atol=0,
                                       err_msg=f"row {i} is no near tie")
    return shares


def _bits(lg, s):
    x = lg - lg.max(-1, keepdims=True)
    lp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    return -lp[np.arange(len(s)), s].sum() / np.log(2)


def _hold(l1, l2, t1, t2, occ):
    """Both phases' logits within LOGIT_TOL, their code lengths 1e-5."""
    for want, got, sym in ((l1, t1, occ[::2]), (l2, t2, occ[1::2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
        w = _bits(np.asarray(want)[0], sym)
        assert abs(_bits(got[0].numpy(), sym) - w) <= 1e-5 * w


def _port(d, p, occ, **switches):
    tm = weights.load_into(TEHEM(static_knn=False, device="cpu", **switches), CKPT)
    t1, tf1, tf2 = tm.decode_phase1(torch.from_numpy(d), torch.from_numpy(p))
    return t1, tm.decode_phase2(tf1, tf2, torch.from_numpy(occ[None, ::2]), False)


def test_dynamic_graph_checkpoint_matches_jax(monkeypatch):
    """Switches off: the chunked KNN on all three graphs, JAX eager with
    SCP_STATIC_KNN unset (exact top-k on the CPU)."""
    from scp_tpu.train.checkpoints import load_params_npz

    monkeypatch.delenv("SCP_STATIC_KNN", raising=False)
    monkeypatch.delenv("SCP_PALLAS_KNN", raising=False)
    d, p, occ = bench_context()
    graphs = _record_graphs(monkeypatch)
    v = load_params_npz(CKPT)
    jm = JEHEM()
    l1, f1, f2 = jm.apply(v, d, p, method=JEHEM.decode_phase1)
    l2 = jm.apply(v, f1, f2, occ[None, ::2], False, method=JEHEM.decode_phase2)
    t1, t2 = _port(d, p, occ)
    assert len(graphs["port"]) == len(graphs["jax"]) == 3
    assert [g[0].shape[-1] for g in graphs["port"]] == [3, 144, 192]
    print("rows whose graph differs from JAX's:", _check_graphs(graphs["port"], graphs["jax"]))
    _hold(l1, l2, t1, t2, occ)


def test_dynamic_graph_checkpoint_with_pallas_knn_matches_jax(jax_kernels_on_cpu, monkeypatch):
    """pallas_knn: D's plain version builds all three graphs (N = 2048),
    JAX's knn_pallas in interpret mode builds its three; the attention
    stays on both packages' default path."""
    from scp_tpu.train.checkpoints import load_params_npz

    monkeypatch.delenv("SCP_STATIC_KNN")  # the fixture's "1"
    monkeypatch.delenv("SCP_PALLAS_ATTN")
    d, p, occ = bench_context()
    l1, _, l2 = _phases(JEHEM(), load_params_npz(CKPT), d, p, occ[None, ::2])
    t1, t2 = _port(d, p, occ, pallas_knn=True)
    calls = jax_kernels_on_cpu
    assert calls["jax_knn"] == calls["knn"] == 3
    assert calls["jax_attn"] == calls["attn"] == 0
    _hold(l1, l2, t1, t2, occ)


def test_narrow_dynamic_codec_with_pallas_knn_is_lossless_and_stamped():
    """A narrow dynamic-graph EHEM with pallas_knn at context 2048: D's
    seam builds all three graphs of each (1, 2048) call, the roundtrip is
    lossless, the stamp names the wide arm's numerics, and a decoder
    refuses a stream whose stamp lacks that field or names another."""
    from scp_tpu_torch.codec import ehem_codec as tcodec
    from scp_tpu_torch.codec.slices import split_levels
    from scp_tpu_torch.core.preprocess import preprocess_points
    from scp_tpu_torch.ops import knn_topk as tknn_topk

    torch.manual_seed(0)
    tm = TEHEM(self_depths=(2, 2), cross_depths=(2, 1), embed_dim=64, num_heads=4,
               window_size=128, mlp_ratio=2.0, knn_k=4, static_knn=False, pallas_knn=True,
               device="cpu")
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

    widths = []
    port_knn = tknn_topk.knn_topk

    def spy(feats, k):
        widths.append(feats.shape[-1])
        return port_knn(feats, k)

    codec = tcodec.EHEMCodec(tm, context_size=2048)
    stamp = codec.coding_params()
    assert f"staticknn=0;pallas_knn=1;knnwide={tcodec.KNN_WIDE_NUMERICS};" in stamp
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tknn_topk, "knn_topk", spy)
        stream, bits, _ = codec.encode_to_stream(sl)
        codes = codec.decode(codec.new_stream_decoder(stream, len(sl.occ_stream),
                                                     coding_params=stamp), sl.max_level,
                             np.array(sl.pos_mm), angular=True,
                             ground_truth=sl.occ_stream, level_sizes=sl.level_sizes)
    np.testing.assert_array_equal(codes, sl.occ_stream)
    assert bits > 0 and widths and widths[:3] == [3, 144, 192]
    assert len(widths) % 6 == 0  # three graphs per call, encode and decode
    field = f"knnwide={tcodec.KNN_WIDE_NUMERICS}"
    for old in (stamp.replace(field + ";", ""), stamp.replace(field, "knnwide=fma")):
        with pytest.raises(ValueError, match=field):
            codec.new_stream_decoder(stream, len(sl.occ_stream), coding_params=old)
    # the static graph never reaches the wide arm: its stamp has no such field
    static = TEHEM(self_depths=(2, 2), cross_depths=(2, 1), embed_dim=64, num_heads=4,
                   window_size=128, mlp_ratio=2.0, knn_k=4, static_knn=True, pallas_knn=True,
                   device="cpu")
    assert "knnwide" not in tcodec.EHEMCodec(static, context_size=2048).coding_params()
    tm.pallas_knn = tm.geo.pallas_knn = False
    assert "knnwide" not in tcodec.EHEMCodec(tm, context_size=2048).coding_params()


def test_bench_dynamic_knn_flags_build_the_dynamic_model():
    """tools/bench.py --dynamic-knn: EHEM(static_knn=False) from
    ehem_synth_f16.npz; --ckpt and --pallas-knn; the default is unchanged."""
    from scp_tpu_torch.tools import bench

    args = bench.parse_args(["--dynamic-knn"])
    assert os.path.samefile(bench.ckpt_path(args), CKPT)
    model = bench.build_model(args, "cpu")
    assert not model.static_knn and not model.geo.static_knn and not model.pallas_knn
    want = np.load(CKPT)
    key = next(k for k in want.files if k.endswith("conv2/conv/kernel"))
    np.testing.assert_array_equal(model.geo.conv2.conv.weight.detach().float().T.numpy(),
                                  want[key].astype(np.float32))
    default = bench.parse_args([])
    assert bench.ckpt_path(default) == bench.CKPT and not default.dynamic_knn
    other = bench.parse_args(["--ckpt", "x.npz", "--pallas-knn"])
    assert bench.ckpt_path(other) == "x.npz" and other.pallas_knn and not other.dynamic_knn
