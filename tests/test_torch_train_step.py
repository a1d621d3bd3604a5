"""One training step of the port's EHEM against scp_tpu's, on the CPU in f32,
and the trainer around it.

The step: the same weights and batch through JAX's value_and_grad of the
trainer's loss (scp_tpu/train/trainer.py:118-147, flax BatchNorm in train
mode) and through the port's forward + backward, in two arms: the fused
EdgeConv with static KNN at C = 128 (the B and C seams taken on the port's
side, kernels' plain versions inside the autograd Functions) and the
explicit EdgeConv with dynamic KNN at C = 64 on an odd-length context
(pad node, unfused Swin path).  JAX on the CPU runs its XLA path, the same
functions, jitted as scp_tpu's trainer jits its step.

A kink of the model (leaky_relu at 0, a max over neighbours with two
near-equal candidates) can fall inside the two packages' f32 rounding: at
a batch of 2 x 256 in the fused arm one unit of prob_pred_mlp2 sat at
+1.2e-7 in the port and -1.5e-8 in JAX, and that one unit's branch gave
a rank-one gradient difference of 4.4e-4 while every other element
agreed within 3e-7.  With about a million such units per batch, the
batches here are one context each (128 and 193 nodes), which have no
unit that close; the tolerances are the stated ones.

Then: 25 trainer steps lower the loss; 4 steps equal 2 steps,
save, resume and 2 more, bit for bit; a port-written npz loads in
scp_tpu and gives the port's logits.
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from scp_tpu.models.ehem import EHEM as JEHEM
from scp_tpu.train import checkpoints as jckpt
from scp_tpu.train.trainer import cross_entropy_bits as jloss
from scp_tpu_torch import weights
from scp_tpu_torch.config import Config, load_config
from scp_tpu_torch.core.octree import build_octree, gen_context
from scp_tpu_torch.models.ehem import EHEM as TEHEM
from scp_tpu_torch.train import checkpoints as tckpt
from scp_tpu_torch.train.data import build_dataset
from scp_tpu_torch.train.trainer import Trainer, cross_entropy_bits

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # x max(1, the leaf's largest magnitude)
STATS_TOL = 1e-5

ARMS = {
    "fused_static_c128": dict(cfg=dict(self_depths=(2, 2), cross_depths=(2, 1), embed_dim=128,
                                       num_heads=4, window_size=64, mlp_ratio=2.0, knn_k=4),
                              n=128, static=True, fused=True),
    "explicit_dynamic_c64": dict(cfg=dict(self_depths=(2, 2), cross_depths=(1,), embed_dim=64,
                                          num_heads=2, window_size=64, mlp_ratio=2.0, knn_k=4),
                                 n=193, static=False, fused=False),
}


def _variables(rng, model, n=8):
    """flax init, then every leaf perturbed from the numpy rng."""
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


def _batch(rng, b, n, max_level=12):
    data = np.zeros((b, n, 4, 3), np.int32)
    data[..., 0] = rng.integers(1, max_level, (b, n, 4))
    data[..., 1] = rng.integers(1, 9, (b, n, 4))
    data[..., 2] = rng.integers(0, 255, (b, n, 4))
    label = data[:, :, 3, 2].copy()
    label[:, -3:] = 255  # pad rows, as a short shard window has
    data[:, :, 3, 2] = label
    return data, rng.random((b, n, 3)).astype(np.float32), label


def _grads_as_variables(model):
    """The port's gradients laid out as flax params (kernels transposed)."""
    g = copy.deepcopy(model)
    with torch.no_grad():
        for p, src in zip(g.parameters(), model.parameters()):
            p.copy_(src.grad)
    return weights.to_variables(g)["params"]


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


@pytest.mark.parametrize("arm", list(ARMS))
def test_one_training_step_matches_jax(monkeypatch, arm):
    spec = ARMS[arm]
    # never "0" for the bool()-read switches; SCP_FUSED_EDGECONV is read as != "0"
    if spec["static"]:
        monkeypatch.setenv("SCP_STATIC_KNN", "1")
    else:
        monkeypatch.delenv("SCP_STATIC_KNN", raising=False)
    monkeypatch.setenv("SCP_FUSED_EDGECONV", "1" if spec["fused"] else "0")
    rng = np.random.default_rng(11)
    jm = JEHEM(**spec["cfg"])
    variables = _variables(rng, jm)
    data, pos, label = _batch(rng, 1, spec["n"])

    def loss_fn(params, stats):
        out, upd = jm.apply({"params": params, "batch_stats": stats}, data, pos, train=True,
                            mutable=["batch_stats"])
        return jloss(out, label), upd["batch_stats"]

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (want_loss, want_stats), want_grads = step(variables["params"], variables["batch_stats"])

    tm = TEHEM(**spec["cfg"], static_knn=spec["static"], fused_edgeconv=spec["fused"],
               device="cpu")
    weights.load_into(tm, variables)
    tm.train()
    loss = cross_entropy_bits(tm(torch.from_numpy(data), torch.from_numpy(pos)),
                              torch.from_numpy(label))
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))

    got = dict(_leaves(_grads_as_variables(tm)))
    want = dict(_leaves(unfreeze(jax.tree_util.tree_map(np.asarray, want_grads))))
    assert set(got) == set(want)
    for k, w in want.items():
        assert np.any(got[k] != 0.0), f"{k}: no gradient"
        tol = GRAD_TOL * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[k], w, atol=tol, rtol=GRAD_TOL, err_msg=k)

    stats = dict(_leaves(weights.to_variables(tm)["batch_stats"]))
    for k, w in _leaves(unfreeze(jax.tree_util.tree_map(np.asarray, want_stats))):
        np.testing.assert_allclose(stats[k], w, atol=STATS_TOL, rtol=STATS_TOL, err_msg=k)


def test_remat_recomputes_without_updating_the_statistics_twice():
    """remat (torch.utils.checkpoint per Swin block and EdgeConv) gives the
    same loss, gradients and BatchNorm statistics as no remat."""
    spec = ARMS["fused_static_c128"]
    rng = np.random.default_rng(3)
    data, pos, label = (torch.from_numpy(a) for a in _batch(rng, 1, spec["n"]))
    out = []
    for remat in (False, True):
        torch.manual_seed(0)
        m = TEHEM(**spec["cfg"], static_knn=True, remat=remat, device="cpu")
        with torch.no_grad():
            for p in m.parameters():
                p.normal_(0.0, 0.05)
        m.train()
        cross_entropy_bits(m(data, pos), label).backward()
        out.append(m)
    a, b = out
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        torch.testing.assert_close(pa.grad, pb.grad, atol=1e-6, rtol=1e-5, msg=name)
    for (name, ba), bb in zip(a.named_buffers(), b.buffers()):
        assert torch.equal(ba, bb), name


def test_codec_entry_points_run_in_eval_mode_and_keep_the_mode():
    spec = ARMS["fused_static_c128"]
    m = TEHEM(**spec["cfg"], static_knn=True, device="cpu").train()
    before = {k: v.clone() for k, v in m.named_buffers()}
    data, pos, _ = (torch.from_numpy(a) for a in _batch(np.random.default_rng(0), 1, 128))
    l1, f1, f2 = m.decode_phase1(data, pos)
    assert not l1.requires_grad and m.training
    assert all(torch.equal(v, before[k]) for k, v in m.named_buffers())


# ---- the trainer ------------------------------------------------------------


def _shards(path, n_files=2, bits=6):
    rng = np.random.default_rng(42)
    for i in range(n_files):
        pts = np.unique(rng.integers(0, 2**bits, (3000, 3)), axis=0)
        ctx = gen_context(build_octree(pts))
        np.save(os.path.join(path, f"shard{i}_{ctx.shape[0]}.npy"), ctx)
    return os.path.join(str(path), "*.npy")


def _tiny_cfg(root):
    """configs/smoke.yaml's model on the shards (tests/test_train.py's tiny config)."""
    cfg = load_config("train_kitti_ehem.yaml", os.path.join(ROOT, "configs"))
    cfg.data.root = root
    cfg.data.batch_size = 2
    cfg.data.context_size = 64
    cfg.model.context_size = 64
    cfg.bf16 = False
    cfg.train.lr = 1e-3
    cfg.model.swin = Config.wrap(dict(embed_dim=64, self_depths=[2, 2], cross_depths=[1],
                                      num_heads=2, window_size=16, mlp_ratio=2.0))
    return cfg


def test_training_reduces_loss(tmp_path):
    cfg = _tiny_cfg(_shards(tmp_path))
    ds = build_dataset(cfg)
    trainer = Trainer(cfg, steps_per_epoch=10, device="cpu")
    trainer.init_state()
    gen = ds.batches()
    losses = [float(trainer.train_step(next(gen))) for _ in range(26)]
    assert losses[0] > 7.5  # ~log2(255) at init
    assert min(losses[-5:]) < losses[0] - 0.5, losses
    assert trainer.step == 26


@pytest.fixture
def deterministic():
    """The gathers' backward (index_put_ with accumulate) adds rows in a
    thread-dependent order unless PyTorch's deterministic algorithms are
    on; bit-exact comparisons of whole runs need them."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def test_resume_is_bit_exact(tmp_path, deterministic):
    cfg = _tiny_cfg(_shards(tmp_path))
    ds = build_dataset(cfg)

    def fresh():
        t = Trainer(cfg, steps_per_epoch=ds.steps_per_epoch(), device="cpu")
        t.init_state()
        return t

    straight = fresh()
    gen = ds.batches()
    for _ in range(4):
        straight.train_step(next(gen))
    first = fresh()
    gen = ds.batches()
    for _ in range(2):
        first.train_step(next(gen))
    path = tckpt.save(str(tmp_path / "run"), first, epoch=0, step=2)
    assert tckpt.latest_checkpoint(str(tmp_path / "run")) == path
    resumed = fresh()
    assert tckpt.restore(path, resumed)["step"] == 2 and resumed.step == 2
    gen = ds.batches(start_step=2)
    for _ in range(2):
        resumed.train_step(next(gen))
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_port_npz_loads_in_jax_with_the_same_logits(tmp_path, monkeypatch):
    monkeypatch.setenv("SCP_STATIC_KNN", "1")
    spec = ARMS["fused_static_c128"]
    tm = TEHEM(**spec["cfg"], static_knn=True, device="cpu")
    with torch.no_grad():
        for p in tm.parameters():
            p.normal_(0.0, 0.05)
        for m in tm.modules():
            if hasattr(m, "running_var"):
                m.running_mean.normal_(0.0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    path = str(tmp_path / "port.npz")
    tckpt.save_params_npz(path, tm)
    with np.load(path) as z:  # scp_tpu's layout: flat flax keys, float16 leaves
        assert all(z[k].dtype == np.float16 for k in z.files)
        assert "params/swin_self/stage_0/block_0/attn/qkv/kernel" in z.files
    jvars = jckpt.load_params_npz(path)
    weights.load_into(tm, path)  # the same f16-rounded values on both sides
    data, pos, _ = _batch(np.random.default_rng(1), 1, 256)
    jm = JEHEM(**spec["cfg"])
    l1, _, _ = jm.apply(jvars, data, pos, method=JEHEM.decode_phase1)
    t1, _, _ = tm.decode_phase1(torch.from_numpy(data), torch.from_numpy(pos))
    np.testing.assert_allclose(t1.numpy(), np.asarray(l1), atol=1e-4, rtol=1e-4)


def test_warm_start_takes_matching_params_only(tmp_path):
    """load_pretrain: the npz's params where path and shape match; the rest
    and the BatchNorm statistics keep their fresh values (scp_tpu's fit)."""
    spec = ARMS["fused_static_c128"]
    src = TEHEM(**spec["cfg"], static_knn=True, device="cpu")
    with torch.no_grad():
        for p in src.parameters():
            p.normal_(0.0, 0.05)
        src.geo.conv1.bn.running_mean.fill_(3.0)
    path = str(tmp_path / "pre.npz")
    tckpt.save_params_npz(path, src)
    cfg = _tiny_cfg(str(tmp_path / "*.npy"))
    cfg.model.swin = Config.wrap(dict(embed_dim=128, self_depths=[2, 2], cross_depths=[2, 1],
                                      num_heads=4, window_size=64, mlp_ratio=2.0))
    cfg.train.load_pretrain = path
    t = Trainer(cfg, steps_per_epoch=1, device="cpu")
    t.init_state()
    want = src.geo.conv1.conv.weight.detach().half().float()
    assert torch.equal(t.model.geo.conv1.conv.weight.detach(), want)
    assert float(t.model.geo.conv1.bn.running_mean.abs().max()) == 0.0


def test_cli_trains_and_writes_the_jax_trainers_metrics(tmp_path):
    """The CLI twin on configs/smoke.yaml, on the CPU: metrics.jsonl lines
    with scp_tpu's keys, the archived config, a checkpoint per epoch."""
    import json

    from scp_tpu_torch.cli import train as cli
    from scp_tpu_torch.config import load_run_config

    root = _shards(tmp_path, n_files=1)
    run = str(tmp_path / "run")
    cli.main(["--config-name", "smoke.yaml", "--config-dir", os.path.join(ROOT, "configs"),
              f"data.root={root}", "--run-dir", run, "device=cpu", "train.log_every=4",
              "train.val_every=8", "data.val_batches=1"])
    with open(os.path.join(run, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    train = [r for r in recs if "train_loss" in r]
    val = [r for r in recs if "val_bits_per_node" in r]
    assert train and val
    assert set(train[0]) == {"step", "epoch", "train_loss", "lr", "wall"}
    assert set(val[0]) == {"step", "epoch", "val_bits_per_node", "wall"}
    assert load_run_config(run).data.root == root
    assert tckpt.latest_checkpoint(run) is not None


def test_bench_ckpt_recipe_writes_an_npz_scp_tpu_loads(tmp_path):
    """tools/train_bench_ckpt.py at its --small size on the CPU: shards from
    the port's preprocess with the recipe's seeds and stamp, two steps, and
    an npz in scp_tpu's format."""
    from scp_tpu_torch.tools import train_bench_ckpt as recipe

    shard_dir, out = str(tmp_path / "shards"), str(tmp_path / "small.npz")
    cwd = os.getcwd()
    os.chdir(ROOT)  # the recipe reads configs/ from the repository root
    try:
        recipe.main(["--steps", "2", "--batch", "2", "--context", "64", "--clouds", "1",
                     "--points", "3000", "--lidar_level", "10", "--shard_dir", shard_dir,
                     "--run_dir", str(tmp_path / "run"), "--out", out, "--small",
                     "--device", "cpu"])
    finally:
        os.chdir(cwd)
    with open(os.path.join(shard_dir, "_gen_meta.json")) as f:
        assert f.read() == '{"system": "spher", "lidar_level": 10, "points": 3000}'
    params = jckpt.load_params_npz(out)["params"]
    assert params["swin_self"]["stage_0"]["block_0"]["attn"]["qkv"]["kernel"].shape == (256, 768)
    with pytest.raises(SystemExit, match="generated with"):  # the stamp refuses another recipe
        recipe.gen_shards(shard_dir, 1, 4000, 10)
