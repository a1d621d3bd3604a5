"""The port's measuring tools on the CPU: profile_codec's reports, the
models' closed-form FLOPs, precompile, scaling_curve's per-device work
(against scp_tpu's, computed here by scp_tpu's own code) and utils.env."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch.utils.flop_counter import FlopCounterMode

from scp_tpu.codec.ehem_codec import EHEMCodec as JaxCodec
from scp_tpu.config import load_config as jax_load_config
from scp_tpu.models.ehem import EHEM as JaxEHEM
from scp_tpu.tools.scaling_curve import _flops as xla_flops
from scp_tpu.train.trainer import Trainer as JaxTrainer
from scp_tpu_torch.codec.ehem_codec import EHEMCodec
from scp_tpu_torch.models.ehem import EHEM
from scp_tpu_torch.models.layers import flax_init_
from scp_tpu_torch.tools import precompile, profile_codec, scaling_curve
from scp_tpu_torch.utils import env

# scp_tpu/tools/profile_codec.py's two reports (:173-192, :245-256); its
# `backend` is `device` in the port
JAX_CODEC_KEYS = {"what", "backend", "device_kind", "mode", "group", "nodes_per_call",
                  "phase1_flops", "phase1_s", "phase1_mfu_pct", "phase2_s", "fetch_hi_cdf_s",
                  "fetch_hi_cdf_bytes", "fetch_iv_s", "fetch_iv_bytes", "ac_enc_s_per_mnode",
                  "ac_dec_s_per_mnode", "peak_flops"}
JAX_TRAIN_KEYS = {"what", "backend", "batch", "context", "step_flops", "step_s", "mfu_pct",
                  "tokens_per_s", "peak_flops"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: under the test run's parallel workers a full
    OpenMP pool makes each of these small ops wait at a barrier for
    descheduled threads (this file took 899 s of a 1034 s run with it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_keys(keys):
    return {"device" if k == "backend" else k for k in keys}


def _narrow(**kw):
    model = EHEM(self_depths=(2, 1, 1), cross_depths=(1, 1), embed_dim=128, num_heads=4,
                 window_size=16, mlp_ratio=2.0, knn_k=4, device="cpu", **kw)
    return flax_init_(model, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("mode", ["rans", "staged", "full"])
def test_profile_codec_reports_scp_tpus_keys(mode):
    args = profile_codec.parse_args(["--what", "codec", "--group", "2", "--context", "64",
                                     "--mode", mode, "--device", "cpu"])
    r = profile_codec.profile_codec(args, model=_narrow(static_knn=True))
    assert _port_keys(JAX_CODEC_KEYS) <= set(r)
    assert r["device"] == "cpu" and r["mode"] == mode and r["nodes_per_call"] == 128
    assert r["phase1_mfu_pct"] is None  # no device metric from a CPU run
    assert r["phase1_s"] > 0 and r["phase2_s"] > 0 and r["ac_dec_s_per_mnode"] > 0
    assert r["phase1_flops"] == _narrow(static_knn=True).phase1_flops(2, 64)
    if mode == "staged":
        assert r["fetch_hi_cdf_bytes"] == 2 * 32 * 17 * 2 and r["fetch_iv_bytes"] > 0
    elif mode == "full":
        assert r["fetch_hi_cdf_bytes"] == 2 * 32 * 256 * 2 and r["fetch_iv_bytes"] == 0


def test_profile_train_reports_scp_tpus_keys(tmp_path):
    """profile_train's recipe step, with the recipe's narrow model on
    small clouds; its shards are removed."""
    args = profile_codec.parse_args(["--what", "train", "--batch", "2", "--context", "64",
                                     "--device", "cpu"])
    work = str(tmp_path / "shards")
    r = profile_codec.profile_train(args, work=work, small=True)
    assert _port_keys(JAX_TRAIN_KEYS) <= set(r)
    assert (r["batch"], r["context"], r["steps"]) == (2, 64, 10) and not os.path.exists(work)
    assert r["step_s"] > 0 and r["mfu_pct"] is None and r["peak_memory_gb"] is None
    assert r["step_flops"] == 3 * r["forward_flops"] > 0
    assert r["tokens_per_s"] == pytest.approx(2 * 64 / r["step_s"])


def test_load_model_refuses_a_missing_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError):
        profile_codec.load_model(str(tmp_path / "missing.npz"), torch.device("cpu"))


@pytest.mark.parametrize("static,width", [(True, 64), (True, 130), (False, 96)])
def test_closed_form_products_equal_flop_counter(static, width):
    """Phase 1, phase 2 and the training forward on the plain path; 130
    pads the deep stages' windows and makes the merges odd."""
    model = _narrow(static_knn=static)
    b = 2
    rng = np.random.default_rng(0)
    data = torch.from_numpy(rng.integers(1, 9, (b, width, 4, 3)))
    pos = torch.from_numpy(rng.random((b, width, 3), dtype=np.float32))
    with FlopCounterMode(display=False) as fc:
        _, f1, f2 = model.decode_phase1(data, pos)
    assert fc.get_total_flops() == model.phase1_flops(b, width)
    occ = torch.from_numpy(rng.integers(0, 255, (b, f1.shape[1])))
    with FlopCounterMode(display=False) as fc:
        model.decode_phase2(f1, f2, occ, False)
    assert fc.get_total_flops() == model.phase2_flops(b, width)
    model.train()
    with FlopCounterMode(display=False) as fc:
        model(data, pos)
    assert fc.get_total_flops() == model.forward_flops(b, width)


def test_precompile_reports_its_shapes_and_times(capsys, monkeypatch):
    """A narrow model in place of the checkpoint's (the full width runs in
    chip_smoke.py phase 13c)."""
    monkeypatch.setattr(profile_codec, "load_model", lambda ckpt, device: _narrow(static_knn=True))
    r = precompile.main(["--points", "1500", "--levels", "9", "--context", "128",
                         "--device", "cpu"])
    assert r["libraries"]["kernels"] is None and r["libraries"]["native"] in ("cold", "cached")
    (cls,) = r["classes"]
    assert cls["phase_shapes"] >= 1 and cls["seed_s"] > 0 and cls["rewarm_s"] > 0
    out = capsys.readouterr().out
    assert "first-call costs" in out and "phase shapes" in out


def test_force_cpu_gives_a_sharded_codec():
    assert env.force_cpu() == torch.device("cpu")
    codec = EHEMCodec(_narrow(static_knn=True), context_size=64, devices=env.force_cpu(4))
    assert "devices=4;" in codec.coding_params()
    with pytest.raises(ValueError):
        env.force_cpu(0)


def test_enable_compilation_cache_is_the_shared_build_dir():
    from scp_tpu_torch.native import build
    from scp_tpu_torch.ops import _cuda

    path = env.enable_compilation_cache()
    assert os.path.isdir(path) and path == _cuda.BUILD_DIR
    assert os.path.realpath(path) == os.path.realpath(build.BUILD_DIR)


# ---- scaling_curve against scp_tpu's --------------------------------------------

def _jax_per_device(n: int) -> tuple:
    """scp_tpu's scaling_curve at n devices (its own code): XLA's per-device
    flops of the grouped phase-1 call and of the train step.  The counts
    do not depend on the values, so the variables and the train state are
    made from their shapes (jax.eval_shape), which saves their compiles."""
    csz = scaling_curve.CONTEXT
    model = JaxEHEM(self_depths=(2, 2), cross_depths=(1,), embed_dim=64, num_heads=2,
                    window_size=16, mlp_ratio=2.0, knn_k=4)
    variables = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(model.init, jax.random.PRNGKey(0), np.zeros((1, 8, 4, 3), np.int32),
                       np.zeros((1, 8, 3), np.float32)))
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    codec = JaxCodec(model, variables, context_size=csz, group_size=8, mesh=mesh)
    db = codec._replicate_or_put(np.zeros((8 * csz, 4, 3), np.int32))
    pb = codec._replicate_or_put(np.zeros((8 * csz, 3), np.int32))
    lowered = jax.jit(codec._p1_buf_fn.__wrapped__, static_argnums=(7, 8)).lower(
        codec.variables, db, pb, np.int32(0), np.int32(2**31 - 1), np.int32(0),
        np.float32(1.0), 8, csz)
    f_codec = xla_flops(lowered.compile())
    cfg = jax_load_config("train_kitti_ehem.yaml", config_dir="configs")
    cfg.model.swin = dict(embed_dim=64, self_depths=[2, 2], cross_depths=[1], num_heads=2,
                          window_size=16, mlp_ratio=2.0)
    cfg.data.batch_size = 8
    cfg.bf16 = False
    trainer = JaxTrainer(cfg, steps_per_epoch=10, mesh=mesh)
    rng = np.random.default_rng(0)
    batch = {"data": rng.integers(0, 9, (8, csz, 4, 3)).astype(np.int32),
             "pos": rng.random((8, csz, 3)).astype(np.float32),
             "label": rng.integers(0, 255, (8, csz)).astype(np.int32)}
    state = jax.eval_shape(trainer.init_state, batch)
    b_dev = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()}, trainer.batch_shard)
    f_train = xla_flops(trainer._build_step().lower(state, b_dev).compile())
    return f_codec, f_train


@pytest.fixture(scope="module")
def port_rows():
    return scaling_curve.main(["--device", "cpu"])


@pytest.fixture(scope="module")
def jax_rows():
    return {n: _jax_per_device(n) for n in (1, 2)}


def test_scaling_curve_divides_the_work(port_rows):
    (n1, c1, t1), *rest = port_rows
    assert n1 == 1 and [r[0] for r in rest] == [2, 4, 8]
    for n, c, t in rest:
        assert abs(c / c1 - 1 / n) <= 1e-6
        assert abs(t / t1 - 1 / n) <= 1e-6


def test_scaling_curve_ratios_match_scp_tpus(port_rows, jax_rows):
    port = {n: (c, t) for n, c, t in port_rows}
    for i, what in enumerate(("codec", "train")):
        jax_ratio = jax_rows[2][i] / jax_rows[1][i]
        assert abs(port[2][i] / port[1][i] - jax_ratio) <= 0.01, what


def test_closed_form_phase1_at_most_xla_cost_analysis(jax_rows):
    """XLA counts the products plus the elementwise ops (and scp_tpu's
    one-hot embedding lookups), so its count of the same narrow phase-1
    call is at least the closed form's products."""
    model = scaling_curve.narrow_model()
    f = model.phase1_flops(scaling_curve.GROUP, scaling_curve.CONTEXT)
    assert 0.9 * jax_rows[1][0] <= f <= jax_rows[1][0]
