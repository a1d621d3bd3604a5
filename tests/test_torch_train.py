"""The port's training host code against the JAX package, on the CPU: the
config reader (no PyYAML) composes every file of configs/ as
scp_tpu.config does, the data pipeline's batches are byte-equal to
scp_tpu.train.data's, and the loss, the StepLR schedule and Adam agree
with scp_tpu's trainer and optax."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from scp_tpu import config as jconfig
from scp_tpu.train import data as jdata
from scp_tpu.train import trainer as jtrainer
from scp_tpu_torch import config as tconfig
from scp_tpu_torch.core.octree import build_octree, gen_context
from scp_tpu_torch.train import data as tdata
from scp_tpu_torch.train import trainer as ttrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(ROOT, "configs")
TOP_CONFIGS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(CONFIG_DIR, "*.yaml")))
ALL_FILES = sorted(glob.glob(os.path.join(CONFIG_DIR, "**", "*.yaml"), recursive=True))
OVERRIDES = ["train.lr=3e-4", "data.root=x/*.npy", "gpus=[0,1]", "model.swin.self_depths=[2,2]",
             "train.flag=true", "new.key=none"]


def make_shards(path, rng, n_files=2, bits=6, points=3000):
    """Training shards from the port's numpy octree (no native builder)."""
    for i in range(n_files):
        pts = np.unique(rng.integers(0, 2**bits, (points, 3)), axis=0)
        ctx = gen_context(build_octree(pts))
        np.save(os.path.join(path, f"shard{i}_{ctx.shape[0]}.npy"), ctx)
    return os.path.join(str(path), "*.npy")


# ---- config -----------------------------------------------------------------


@pytest.mark.parametrize("path", ALL_FILES, ids=lambda p: os.path.relpath(p, CONFIG_DIR))
def test_yaml_subset_reads_every_config_file_as_pyyaml(path):
    with open(path) as f:
        text = f.read()
    assert tconfig.yaml_load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("name", TOP_CONFIGS)
def test_load_config_matches_jax_package(name):
    want = jconfig.load_config(name, CONFIG_DIR, OVERRIDES).to_plain()
    assert tconfig.load_config(name, CONFIG_DIR, OVERRIDES).to_plain() == want
    assert (tconfig.load_config(name, CONFIG_DIR).to_plain()
            == jconfig.load_config(name, CONFIG_DIR).to_plain())


def test_save_config_round_trips(tmp_path):
    cfg = tconfig.load_config("train_kitti_ehem.yaml", CONFIG_DIR, OVERRIDES)
    cfg.train.small = 1e-5  # written as 1.0e-05: "1e-05" would read back as a string
    cfg.train.words = ["yes", "", "a: b", "#x", "012", "null"]
    cfg.train.empty = {}
    cfg.train.none = None
    tconfig.save_config(cfg, str(tmp_path))
    assert tconfig.load_run_config(str(tmp_path)).to_plain() == cfg.to_plain()
    with open(tmp_path / "config.yaml") as f:  # PyYAML reads it the same
        assert yaml.safe_load(f) == cfg.to_plain()
    jconfig.save_config(cfg, str(tmp_path / "j"))  # and the port reads scp_tpu's file
    assert tconfig.load_run_config(str(tmp_path / "j")).to_plain() == cfg.to_plain()


def test_yaml_subset_refuses_what_it_does_not_read():
    for text in ("a: &x 1", "a: |\n  b", "a: {b: 1}", "a:\n  - b:\n    c: 1"):
        with pytest.raises(ValueError):
            tconfig.yaml_load(text)


# ---- data ---------------------------------------------------------------------


@pytest.mark.parametrize("vari", [False, True])
def test_batches_equal_jax_package_for_three_epochs(tmp_path, rng, vari):
    root = make_shards(tmp_path, rng, n_files=3, bits=7)
    kw = dict(context_size=128, batch_size=3, mode="ehem", vari_data_len=vari, seed=5)
    jds, tds = jdata.ShardDataset(root, **kw), tdata.ShardDataset(root, **kw)
    spe = tds.steps_per_epoch()
    assert spe == jds.steps_per_epoch() and spe >= 3
    jg, tg = jds.batches(), tds.batches()
    lengths = set()
    for _ in range(3 * spe):
        jb, tb = next(jg), next(tg)
        for k in ("data", "pos", "label"):
            assert jb[k].dtype == tb[k].dtype and jb[k].shape == tb[k].shape
            assert jb[k].tobytes() == tb[k].tobytes(), k
        lengths.add(tb["data"].shape[1])
    # a resumed stream replays the same batches
    jb, tb = next(jds.batches(start_step=spe + 1)), next(tds.batches(start_step=spe + 1))
    assert all(jb[k].tobytes() == tb[k].tobytes() for k in jb)
    assert tb["label"].max() <= 255 and tb["pos"].min() >= 0 and tb["pos"].max() <= 1


def test_vari_data_len_takes_the_buckets(tmp_path, rng):
    root = make_shards(tmp_path, rng, bits=7)
    ds = tdata.ShardDataset(root, context_size=8192, batch_size=1, mode="ehem", vari_data_len=True,
                            seed=3)
    gen = ds.batches()
    seen = {next(gen)["data"].shape[1] for _ in range(30)}
    assert seen <= set(tdata.EHEM_LEN_BUCKETS) | {8192} and len(seen) > 1
    assert tdata.EHEM_LEN_BUCKETS == jdata.EHEM_LEN_BUCKETS


def test_octattn_mode_is_not_ported(tmp_path, rng):
    """The octattn mode is ported now (its parity: tests/test_torch_octattn_train.py):
    it is the default, and it returns (occupancy, level, octant) batches."""
    root = make_shards(tmp_path, rng, n_files=1)
    ds = tdata.ShardDataset(root, context_size=32, batch_size=2)
    assert ds.mode == "octattn"
    b = next(ds.batches())
    assert b["data"].shape == b["pos"].shape == (2, 32, 4, 3) and b["label"].shape == (2, 32)
    assert (b["label"] == b["data"][:, :, -1, 0]).all()
    with pytest.raises(ValueError, match="mode"):
        tdata.ShardDataset(root, context_size=32, batch_size=2, mode="voxel")


def test_prefetch_hands_over_worker_errors():
    def gen():
        yield 1
        raise RuntimeError("boom")

    it = tdata.prefetch(gen())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


# ---- loss, schedule, optimizer ------------------------------------------------


def test_cross_entropy_bits_counts_pads_in_the_mean(rng):
    logits = rng.normal(0, 3, (2, 50, 255)).astype(np.float32)
    labels = rng.integers(0, 255, (2, 50)).astype(np.int32)
    labels[:, ::7] = 255  # pads: no class
    want = float(jtrainer.cross_entropy_bits(jnp.asarray(logits), jnp.asarray(labels)))
    t = torch.from_numpy(logits).requires_grad_(True)
    got = ttrainer.cross_entropy_bits(t, torch.from_numpy(labels))
    assert abs(float(got.detach()) - want) <= 1e-6 * abs(want)
    ignore = torch.nn.functional.cross_entropy(
        t.detach().reshape(-1, 255), torch.from_numpy(labels).long().reshape(-1),
        ignore_index=255) / np.log(2)
    assert abs(float(ignore) - want) > 1e-3  # ignore_index would change the loss
    got.backward()  # a pad's logits get no gradient: it adds a constant 0 to the sum
    assert float(t.grad[torch.from_numpy(labels) == 255].abs().sum()) == 0.0
    assert float(t.grad[torch.from_numpy(labels) != 255].abs().min()) > 0.0


def test_schedule_matches_jax_for_three_epochs():
    cfg = tconfig.load_config("train_kitti_ehem.yaml", CONFIG_DIR,
                              ["train.lr_scheduler.step_size=1", "train.lr_scheduler.gamma=0.5"])
    jcfg = jconfig.load_config("train_kitti_ehem.yaml", CONFIG_DIR,
                               ["train.lr_scheduler.step_size=1", "train.lr_scheduler.gamma=0.5"])
    spe = 4
    ts, js = ttrainer.make_lr_schedule(cfg, spe), jtrainer.make_lr_schedule(jcfg, spe)
    assert [ts(s) for s in range(3 * spe + 1)] == [js(s) for s in range(3 * spe + 1)]
    assert ts(spe - 1) == cfg.train.lr and ts(spe) == cfg.train.lr * 0.5


def test_adam_updates_match_optax(rng):
    """Three steps fed the same gradients, learning rate read at the count
    before each update (optax.scale_by_schedule)."""
    shapes = [(7, 5), (5,), (3, 2, 4)]
    params = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(0, 1, s).astype(np.float32) for s in shapes] for _ in range(3)]

    def schedule(step):
        return 1e-3 * 0.5 ** (step // 2)

    tx = optax.adam(schedule)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = ttrainer.make_optimizer(tp, schedule(0))
    for step, g in enumerate(grads):
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        before = [p.detach().clone() for p in tp]
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        for group in opt.param_groups:
            group["lr"] = schedule(step)
        opt.step()
        for p, b, u in zip(tp, before, upd):
            np.testing.assert_allclose((p.detach() - b).numpy(), np.asarray(u), atol=1e-6, rtol=0)
    for p, j in zip(tp, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), atol=1e-6, rtol=0)


def test_trainer_refuses_octattention():
    """OctAttention trains now; what the trainer still refuses is an EHEM
    switch on it."""
    cfg = tconfig.load_config("train_kitti.yaml", CONFIG_DIR)
    assert type(ttrainer.Trainer(cfg, steps_per_epoch=1, device="cpu").model).__name__ == (
        "OctAttention")
    with pytest.raises(ValueError, match="switches"):
        ttrainer.Trainer(cfg, steps_per_epoch=1, device="cpu", static_knn=True)
