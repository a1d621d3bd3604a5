"""Data-parallel training of the port (scp_tpu_torch.train.distributed, the
process-strided ShardDataset, global-batch BatchNorm and dropout, the
trainer's gradient average, the training CLI's ranks) against scp_tpu on
the CPU, in f32, with ranks over gloo.

The ranks are spawned processes (train/distributed.py::run_workers) that
meet at a rendezvous file under tmp_path, with one intra-op thread each
and a timeout on every join.  One spawn runs every arm's step
(tools/dryrun_multichip.py::steps_worker), so the rank start-up is paid
once.  The two ranks' rows differ in their statistics (the second row's
positions squeezed into [0.6, 0.85]), so a rank that normalized with its
own rows' BatchNorm statistics, or drew its own dropout masks, would fail
the comparison.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch
from flax.core import unfreeze
from jax.sharding import Mesh

from scp_tpu.config import load_config as jload_config
from scp_tpu.train import data as jdata
from scp_tpu.train.trainer import Trainer as JTrainer
from scp_tpu_torch import weights
from scp_tpu_torch.config import load_config
from scp_tpu_torch.models import build_model
from scp_tpu_torch.tools import dryrun_multichip as dry
from scp_tpu_torch.train import distributed, trainer as ttrainer
from scp_tpu_torch.train.data import ShardDataset, build_dataset
from test_torch_octattention import random_variables
from test_torch_train_step import GRAD_TOL, LOSS_RTOL, STATS_TOL, _batch, _shards, _variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs")
JOIN_S = 300  # every spawned run fails its test past this
OCT_OVERRIDES = ["model.occ_embed_dim=16", "model.level_embed_dim=4",
                 "model.octant_embed_dim=4", "model.abs_pos_embed_dim=8", "model.layer_num=2",
                 "model.head_num=2", "model.hidden_dimension=64", "model.context_size=64",
                 "data.context_size=64", "data.batch_size=2", "bf16=False"]
# EHEM arms: the switches of both packages (scp_tpu reads them from the environment)
EHEM_ARMS = {"ehem_fused_static": dict(static_knn=True, fused_edgeconv=True),
             "ehem_explicit_dynamic": dict(static_knn=False, fused_edgeconv=False)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ehem_cfg(loader):
    cfg = loader("train_kitti_ehem.yaml", CONFIGS)
    cfg.data.batch_size = 2
    cfg.data.context_size = 64
    cfg.model.context_size = 64
    cfg.bf16 = False
    cfg.model.swin = type(cfg).wrap(dict(embed_dim=64, self_depths=[2, 2], cross_depths=[1],
                                    num_heads=2, window_size=16, mlp_ratio=2.0))
    return cfg


def _split_rows(batch):
    """The second row's positions squeezed, so the ranks' statistics differ."""
    data, pos, label = batch
    pos = pos.copy()
    pos[1] = 0.6 + 0.25 * pos[1]
    return {"data": data, "pos": pos, "label": label}


def _oct_batch(rng, b=2, n=64, max_level=12):
    from test_torch_octattention import random_inputs

    data, pos = random_inputs(rng, (b, n), max_level=max_level)
    data[..., 0] = rng.integers(0, 255, (b, n, 4))
    data[..., 1] = np.sort(data[..., 1], axis=-1)
    data[:, -3:, -1, 0] = 255
    pos[1] = 0.6 + 0.25 * pos[1]
    return {"data": data, "pos": pos, "label": data[:, :, -1, 0].copy()}


def _arms(tmp):
    """Per arm: the config (both packages'), the switches, the flax
    variables, the global batch, and the port's state file."""
    arms = {}
    for name, sw in EHEM_ARMS.items():
        rng = np.random.default_rng(11)
        jcfg, tcfg = _ehem_cfg(jload_config), _ehem_cfg(load_config)
        from scp_tpu.models.ehem import EHEM as JEHEM

        variables = _variables(rng, JEHEM.from_config(jcfg))
        arms[name] = dict(jcfg=jcfg, cfg=tcfg, switches=sw, variables=variables,
                          batch=_split_rows(_batch(rng, 2, 64)))
    for name, p in (("octattn", 0.0), ("octattn_dropout", 0.1)):
        rng = np.random.default_rng(5)
        over = OCT_OVERRIDES + [f"train.dropout={p}"]
        jcfg = jload_config("train_kitti.yaml", CONFIGS, over)
        from scp_tpu.models import build_model as jbuild

        variables = {"params": random_variables(rng, jbuild(jcfg))["params"]}
        arms[name] = dict(jcfg=jcfg, cfg=load_config("train_kitti.yaml", CONFIGS, over),
                          switches={}, variables=variables, batch=_oct_batch(rng))
    for name, arm in arms.items():
        model = build_model(arm["cfg"], torch.float32, device="cpu", **arm["switches"])
        weights.load_into(model, arm["variables"])
        arm["state"] = str(tmp / f"{name}.pt")
        torch.save(model.state_dict(), arm["state"])
        arm["spec"] = dict(cfg=arm["cfg"].to_plain(), state=arm["state"], batches=[arm["batch"]],
                           device="cpu", switches=arm["switches"])
    return arms


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every arm's step on 2 gloo ranks (one spawn) and on 1 rank (this
    process)."""
    tmp = tmp_path_factory.mktemp("dp")
    arms = _arms(tmp)
    names = list(arms)
    ranks = distributed.run_workers(dry.steps_worker, 2, args=([arms[n]["spec"] for n in names],),
                                    workdir=str(tmp / "rdzv"), timeout_s=JOIN_S)
    for i, n in enumerate(names):
        arms[n]["ranks"] = [r[i] for r in ranks]
        arms[n]["one"] = dry.step_worker(arms[n]["spec"])
    return arms


def _as_variables(cfg, switches, tensors, variables):
    """Port tensors by state-dict name (grads or buffers) as flax leaves."""
    model = build_model(cfg, torch.float32, device="cpu", **switches)
    weights.load_into(model, variables)
    sd = model.state_dict()
    sd.update({k: v for k, v in tensors.items() if k in sd})
    model.load_state_dict(sd)
    return weights.to_variables(model)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _assert_close(got, want, tol, what):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want), what
    for k, w in want.items():
        bound = tol * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[k], w, atol=bound, rtol=tol, err_msg=f"{what} {k}")


def _jax_mesh_step(arm, monkeypatch):
    """scp_tpu's Trainer over a 2-device mesh, one step from the arm's
    variables -> (loss, gradients (Adam's first moment / (1 - b1)), stats)."""
    sw = arm["switches"]
    if sw.get("static_knn"):
        monkeypatch.setenv("SCP_STATIC_KNN", "1")
    else:
        monkeypatch.delenv("SCP_STATIC_KNN", raising=False)
    if "fused_edgeconv" in sw:
        monkeypatch.setenv("SCP_FUSED_EDGECONV", "1" if sw["fused_edgeconv"] else "0")
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    jt = JTrainer(arm["jcfg"], steps_per_epoch=1, mesh=mesh)
    state = jt.init_state(arm["batch"])
    v = arm["variables"]
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    state = dataclasses.replace(state, params=params,
                                batch_stats=v.get("batch_stats", state.batch_stats),
                                opt_state=jt.tx.init(params))
    state = jax.device_put(state, jt.repl)
    state, loss = jt.train_step(state, arm["batch"])
    adam = [s for s in state.opt_state if isinstance(s, optax.ScaleByAdamState)][0]
    grads = jax.tree_util.tree_map(lambda m: np.asarray(m) / (1.0 - 0.9), adam.mu)
    return float(loss), unfreeze(grads), unfreeze(jax.tree_util.tree_map(np.asarray,
                                                                         state.batch_stats))


@pytest.mark.parametrize("arm", ["ehem_fused_static", "ehem_explicit_dynamic", "octattn"])
def test_two_rank_step_matches_the_jax_mesh_step(two_ranks, arm, monkeypatch):
    a = two_ranks[arm]
    want_loss, want_grads, want_stats = _jax_mesh_step(a, monkeypatch)
    r0, r1 = a["ranks"]
    assert (r0["rank"], r1["rank"], r0["world"]) == (0, 1, 2)
    assert r0["loss"] == r1["loss"]
    assert abs(r0["loss"] - want_loss) <= LOSS_RTOL * abs(want_loss)
    # one replicated update: the same parameters on both ranks
    assert r0["params_sha256"] == r1["params_sha256"] and r1["grads"] is None
    got = _as_variables(a["cfg"], a["switches"], r0["grads"], a["variables"])["params"]
    _assert_close(got, want_grads, GRAD_TOL, f"{arm} gradient")
    if want_stats:
        for r in (r0, r1):
            stats = _as_variables(a["cfg"], a["switches"], r["buffers"],
                                  a["variables"])["batch_stats"]
            _assert_close(stats, want_stats, STATS_TOL, f"{arm} statistics of rank {r['rank']}")


@pytest.mark.parametrize("arm", ["octattn_dropout", "ehem_explicit_dynamic"])
def test_two_ranks_equal_one_rank_on_the_global_batch(two_ranks, arm):
    """Dropout 0.1 (masks of the global batch, each rank its rows) and the
    explicit EdgeConv (BatchNorm with the gradient through the global
    statistics): 2 ranks compute the 1-rank step."""
    a = two_ranks[arm]
    one, (r0, r1) = a["one"], a["ranks"]
    assert one["world"] == 1
    assert abs(r0["loss"] - one["loss"]) <= LOSS_RTOL * abs(one["loss"])
    for k, g in one["grads"].items():
        tol = GRAD_TOL * max(1.0, float(g.abs().max()))
        torch.testing.assert_close(r0["grads"][k], g, atol=tol, rtol=GRAD_TOL, msg=k)
    for r in (r0, r1):
        for k, b in one["buffers"].items():
            torch.testing.assert_close(r["buffers"][k], b, atol=STATS_TOL, rtol=STATS_TOL, msg=k)


def test_dropout_masks_of_a_rank_are_its_rows_of_the_global_masks():
    from scp_tpu_torch.models.octattention import dropout

    x = torch.ones(4, 3, 5)
    whole = dropout(x, 0.5, ttrainer.dropout_generator(3, 2, "cpu"))
    halves = [dropout(x[2 * i : 2 * i + 2], 0.5, ttrainer.dropout_generator(3, 2, "cpu"),
                      rows=(i, 2)) for i in range(2)]
    assert torch.equal(torch.cat(halves), whole)
    assert not torch.equal(halves[0], halves[1])


def test_process_slices_compose_to_the_global_batch_and_equal_jax(tmp_path):
    """(i) P = 2 process slices of the port compose to its global batch and
    are byte-equal to scp_tpu's ShardDataset(process_index=p,
    process_count=2), with vari_data_len on, over 15 epochs."""
    root = _shards(tmp_path)
    kw = dict(context_size=1024, mode="ehem", vari_data_len=True, seed=9)
    whole = ShardDataset(root, batch_size=4, **kw)
    parts = [ShardDataset(root, batch_size=2, process_index=p, process_count=2, **kw)
             for p in range(2)]
    jparts = [jdata.ShardDataset(root, batch_size=2, process_index=p, process_count=2, **kw)
              for p in range(2)]
    assert whole.steps_per_epoch() == parts[0].steps_per_epoch() == jparts[0].steps_per_epoch()
    gens = [whole.batches()] + [p.batches() for p in parts] + [p.batches() for p in jparts]
    lengths = set()
    for _ in range(30):  # 15 epochs; seed 9 truncates step 28 to 512 nodes
        want, p0, p1, j0, j1 = (next(g) for g in gens)
        lengths.add(want["data"].shape[1])
        for key in ("data", "pos", "label"):
            np.testing.assert_array_equal(np.concatenate([p0[key], p1[key]]), want[key])
            for a, b in ((p0, j0), (p1, j1)):
                assert a[key].dtype == b[key].dtype and a[key].tobytes() == b[key].tobytes()
    assert len(lengths) > 1  # the truncation draw is shared by the ranks


def test_build_dataset_divides_the_global_batch(tmp_path, monkeypatch):
    """Rank 1 of 2 (the process group's answers stood in for)."""
    monkeypatch.setattr(distributed, "world_size", lambda: 2)
    monkeypatch.setattr(distributed, "rank", lambda: 1)
    cfg = _ehem_cfg(load_config)
    cfg.data.root = _shards(tmp_path)
    cfg.data.batch_size = 4
    ds = build_dataset(cfg)
    assert (ds.batch_size, ds.process_index, ds.process_count) == (2, 1, 2)
    cfg.data.batch_size = 3
    with pytest.raises(ValueError, match="not divisible by 2 processes"):
        build_dataset(cfg)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_maybe_initialize_and_a_one_process_coordinator_bring_up(tmp_path):
    """(ii) unset -> 0 and nothing brought up; SCP_COORDINATOR with one
    process: a gloo group of one, and the trainer's fit runs in it (scp_tpu
    tests/test_train.py:235-276)."""
    assert distributed.maybe_initialize(env={}) == 0
    assert not torch.distributed.is_initialized()
    root = _shards(tmp_path)
    prog = f"""
import torch, torch.distributed as dist
torch.set_num_threads(1)
from scp_tpu_torch.train.distributed import maybe_initialize, world_size
assert maybe_initialize(device="cpu") == 0
assert dist.is_initialized() and world_size() == 1 and dist.get_backend() == "gloo"
from scp_tpu_torch.config import load_config
from scp_tpu_torch.train.data import build_dataset
from scp_tpu_torch.train.trainer import Trainer
cfg = load_config("smoke.yaml", {CONFIGS!r})
cfg.data.root = {root!r}
cfg.device = "cpu"
t = Trainer(cfg, steps_per_epoch=2, device="cpu")
t.fit(build_dataset(cfg), {str(tmp_path / "dist")!r}, epochs=1)
assert t.step == 2
dist.destroy_process_group()
print("DIST_SMOKE_OK")
"""
    env = dict(os.environ, SCP_COORDINATOR=f"localhost:{_free_port()}", SCP_NUM_PROCESSES="1",
               SCP_PROCESS_ID="0", PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", prog], env=env, capture_output=True, text=True,
                         timeout=JOIN_S, cwd=ROOT)
    assert "DIST_SMOKE_OK" in out.stdout, out.stderr[-3000:]


def test_cli_trains_on_two_cpu_ranks_and_resumes(tmp_path):
    """(v) cli.train device=cpu devices=2: two gloo ranks, one run dir
    written by rank 0 (one metrics line per logged step, not two), then a
    resume that continues from rank 0's checkpoint."""
    import json

    from scp_tpu_torch.cli import train as cli

    root = _shards(tmp_path)
    run = str(tmp_path / "run")
    base = ["--config-name", "smoke.yaml", "--config-dir", CONFIGS, f"data.root={root}",
            "--run-dir", run, "device=cpu", "devices=2", "data.batch_size=2", "data.val_batches=1",
            "data.context_size=256",
            "train.log_every=1", "train.val_every=0"]
    assert cli.local_ranks(load_config("smoke.yaml", CONFIGS, ["device=cpu", "devices=2",
                                                                "data.batch_size=2"])) == 2
    assert cli.main(base + ["train.epoch=1"]) is None  # the ranks ran in spawned processes
    ckpts = sorted(os.listdir(os.path.join(run, "ckpt")))
    with open(os.path.join(run, "metrics.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps == sorted(set(steps)) and steps[0] == 1  # rank 0 alone wrote it
    last = steps[-1]
    assert f"epoch=0-step={last}.pt" in ckpts and "latest.txt" in ckpts
    assert os.path.exists(os.path.join(run, "config.yaml"))
    cli.main(base + ["train.epoch=2", "train.load_ckpt=" + os.path.join(
        run, "ckpt", f"epoch=0-step={last}.pt")])
    with open(os.path.join(run, "metrics.jsonl")) as f:
        steps2 = [json.loads(line)["step"] for line in f]
    assert steps2[len(steps):] == list(range(last + 1, 2 * last + 1))
    assert f"epoch=1-step={2 * last}.pt" in os.listdir(os.path.join(run, "ckpt"))


def test_a_failing_rank_fails_the_run(tmp_path):
    with pytest.raises(RuntimeError, match=r"rank [01] of 2 failed"):
        distributed.run_workers(dry.example_batch, 2, args=(None, 8), workdir=str(tmp_path),
                                timeout_s=JOIN_S)
