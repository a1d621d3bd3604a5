"""OctAttention training in the port (scp_tpu_torch.models.octattention's
dropout, ShardDataset(mode="octattn"), the trainer, the training CLI and
the weights both ways) held against scp_tpu on the CPU, in f32, at the
tiny width of tests/test_torch_octattention.py.

Parity with JAX runs at dropout 0: the masks come from a torch.Generator
seeded with (seed + 1, step), and their bits cannot match JAX's RNG.  At
p = 0.5 the tests hold what dropout must do in the port alone: the same
(seed, step) gives the same loss, eval mode and p = 0 give the
deterministic forward, one site keeps a binomial share of 1 - p and scales
what it keeps by 1 / (1 - p), and the codec's steps never drop.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from scp_tpu.config import load_config as jload_config
from scp_tpu.models.octattention import OctAttention as JOctAttention
from scp_tpu.train import checkpoints as jckpt
from scp_tpu.train import data as jdata
from scp_tpu.train import trainer as jtrainer
from scp_tpu_torch import weights
from scp_tpu_torch.cli import train as tcli
from scp_tpu_torch.cli.codec_common import load_weights
from scp_tpu_torch.config import load_config
from scp_tpu_torch.core.octree import build_octree, gen_context
from scp_tpu_torch.models import octattention as toct
from scp_tpu_torch.models.layers import flax_init_
from scp_tpu_torch.train import checkpoints as tckpt
from scp_tpu_torch.train import data as tdata
from scp_tpu_torch.train import trainer as ttrainer
from test_torch_octattention import ATOL, RTOL, TINY, random_inputs, random_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs")
# tests/test_torch_train_step.py's limits: summation order only
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # x max(1, the leaf's largest magnitude)
# configs/model/oct_attn.yaml cut to TINY's widths, one context of 64 nodes
TINY_OVERRIDES = ["model.occ_embed_dim=16", "model.level_embed_dim=4",
                  "model.octant_embed_dim=4", "model.abs_pos_embed_dim=8", "model.layer_num=2",
                  "model.head_num=2", "model.hidden_dimension=64", "model.context_size=64",
                  "data.batch_size=2", "bf16=False", "devices=1"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these tests run thousands of small torch ops,
    which crawl when every test worker's thread pool spans all the cores
    (the suite runs several workers on one machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def make_shards(path, bits=(6, 7), points=3000, seed=42):
    """Training shards of different deepest levels (one per entry of bits)."""
    rng = np.random.default_rng(seed)
    for i, b in enumerate(bits):
        pts = np.unique(rng.integers(0, 2**b, (points, 3)), axis=0)
        ctx = gen_context(build_octree(pts))
        np.save(os.path.join(path, f"shard{i}_{ctx.shape[0]}.npy"), ctx)
    return os.path.join(str(path), "*.npy")


def train_batch(rng, b, n, max_level=12):
    """An octattn-mode batch: occupancy 0..254 (pads 255 in the last rows),
    levels ascending along the ancestors, labels the node's occupancy."""
    data, pos = random_inputs(rng, (b, n), max_level=max_level)
    data[..., 0] = rng.integers(0, 255, (b, n, 4))
    data[..., 1] = np.sort(data[..., 1], axis=-1)
    data[:, -3:, -1, 0] = 255
    return data, pos, data[:, :, -1, 0].copy()


def port_model(variables, dropout=0.0):
    return weights.load_into(toct.OctAttention(**TINY, dropout=dropout, device="cpu"), variables)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _grads_as_variables(model):
    """The port's gradients laid out as flax params (kernels transposed)."""
    sd = {n: p.grad for n, p in model.named_parameters()}
    g = toct.OctAttention(**TINY, device="cpu")
    g.load_state_dict(sd)
    return weights.to_variables(g)["params"]


# A parameter whose gradient is 0 in exact arithmetic gets rounding noise
# from each package instead: the key projection's bias (it adds q.b to
# every score of a query's row, which softmax cancels) and the key
# kernel's entries on an input feature that is constant over a window.
# An Adam step moves every element by about lr with its gradient's sign,
# so such an element moves by +-lr in either package at random.  Those
# elements (at some step, both packages' gradients within NOISE x max(1,
# the leaf's largest) and not both exactly 0; a sign flipped only where
# both were <= 6e-8 here)
# are held to Adam's bound, lr per step, and every other element to
# GRAD_TOL.  They are 1% of the elements here; the test fails past 2%.
# Where JAX's gradient of such an element is above SIGN_FLOOR, the port's
# has its sign, so a sign error on a small but real gradient still fails.
NOISE = 1e-6
SIGN_FLOOR = 1e-7


def _assert_tree_close(got, want, tol=GRAD_TOL):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    for k, w in want.items():
        bound = tol * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[k], w, atol=bound, rtol=tol, err_msg=k)


# ---- the model in training ------------------------------------------------------


def test_train_forward_loss_and_gradients_match_jax():
    """The loss and every gradient leaf of a train-mode forward + backward
    against jax.value_and_grad of scp_tpu's apply(train=True), p = 0."""
    rng = np.random.default_rng(0)
    jm = JOctAttention(**TINY)
    variables = random_variables(rng, jm)
    data, pos, label = train_batch(rng, 2, 48)

    def loss_fn(params):
        return jtrainer.cross_entropy_bits(jm.apply({"params": params}, data, pos, train=True),
                                           label)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    tm = port_model(variables).train()
    loss = ttrainer.cross_entropy_bits(tm(torch.from_numpy(data), torch.from_numpy(pos)),
                                       torch.from_numpy(label))
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    assert all(p.grad is not None and bool(p.grad.any()) for p in tm.parameters())
    _assert_tree_close(_grads_as_variables(tm),
                       unfreeze(jax.tree_util.tree_map(np.asarray, want_grads)))


def test_flax_init_draws_at_flax_scales():
    """The trainer's fresh parameters (flax_init_) have the spread of
    scp_tpu's init at full width: each leaf's std within 5% of flax's
    (leaves of >= 10,000 elements), biases 0, LayerNorm scales 1."""
    jvars = JOctAttention().init(jax.random.PRNGKey(0), np.zeros((1, 8, 4, 3), np.int32),
                                 np.zeros((1, 8, 4, 3), np.float32))
    want = dict(_leaves(unfreeze(jax.tree_util.tree_map(np.asarray, jvars))["params"]))
    tm = flax_init_(toct.OctAttention(device="cpu"), torch.Generator().manual_seed(3))
    got = dict(_leaves(weights.to_variables(tm)["params"]))
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        if k.endswith("bias"):
            assert not got[k].any() and not w.any(), k
        elif k.endswith("scale"):
            assert (got[k] == 1.0).all() and (w == 1.0).all(), k
        elif w.size >= 10_000:
            assert abs(got[k].std() / w.std() - 1.0) < 0.05, (k, got[k].std(), w.std())
            assert abs(got[k].mean()) < 0.05 * w.std(), k


@torch.no_grad()
def _losses_at_p(tm, data, pos, label, gens):
    return [float(ttrainer.cross_entropy_bits(tm(data, pos, generator=g), label)) for g in gens]


def test_dropout_masks_are_a_function_of_seed_and_step():
    rng = np.random.default_rng(1)
    variables = random_variables(rng, JOctAttention(**TINY))
    data, pos, label = (torch.from_numpy(a) for a in train_batch(rng, 2, 48))
    tm = port_model(variables, dropout=0.5).train()
    a, b, c = _losses_at_p(tm, data, pos, label, [ttrainer.dropout_generator(42, 7, "cpu"),
                                                  ttrainer.dropout_generator(42, 7, "cpu"),
                                                  ttrainer.dropout_generator(42, 8, "cpu")])
    assert a == b and a != c
    with pytest.raises(ValueError, match="Generator"):  # never the global RNG
        tm(data, pos)


def test_eval_mode_and_p0_give_the_deterministic_forward():
    rng = np.random.default_rng(2)
    variables = random_variables(rng, JOctAttention(**TINY))
    data, pos, _ = (torch.from_numpy(a) for a in train_batch(rng, 2, 48))
    with torch.no_grad():
        want = port_model(variables).eval()(data, pos)
        dropping = port_model(variables, dropout=0.5)
        assert torch.equal(dropping.eval()(data, pos), want)
        assert torch.equal(port_model(variables).train()(
            data, pos, generator=ttrainer.dropout_generator(0, 0, "cpu")), want)
        assert not torch.equal(dropping.train()(
            data, pos, generator=ttrainer.dropout_generator(0, 0, "cpu")), want)


def test_dropout_keeps_a_binomial_share_and_scales_it(monkeypatch):
    """Every site's input and output recorded through one forward: 8 sites
    per layer (both streams' attention weights, attention outputs, FFN
    hidden layers and FFN outputs); at the FFN hidden site of the first
    layer, the kept share of the nonzero inputs is within 6 binomial
    standard deviations of 1 - p and each kept value is its input / (1 - p)."""
    p = 0.5
    seen = []
    raw = toct.dropout

    def recording(x, p, generator, rows):
        y = raw(x, p, generator, rows)
        seen.append((x.detach(), y.detach()))
        return y

    monkeypatch.setattr(toct, "dropout", recording)
    rng = np.random.default_rng(3)
    variables = random_variables(rng, JOctAttention(**TINY))
    data, pos, _ = (torch.from_numpy(a) for a in train_batch(rng, 2, 48))
    tm = port_model(variables, dropout=p).train()
    with torch.no_grad():
        tm(data, pos, generator=ttrainer.dropout_generator(5, 0, "cpu"))
    assert len(seen) == 8 * TINY["num_layers"]
    hidden = [(x, y) for x, y in seen if x.shape[-1] == TINY["hidden_dim"]]
    assert len(hidden) == 2 * TINY["num_layers"]
    x, y = hidden[0]
    live = x != 0
    kept = (y != 0) & live
    n = int(live.sum())
    share = float(kept.sum()) / n
    assert abs(share - (1 - p)) <= 6 * np.sqrt(p * (1 - p) / n), (share, n)
    assert torch.equal(y[kept], x[kept] / (1 - p))
    assert not y[live & ~kept].any()


def test_decode_steps_never_drop():
    rng = np.random.default_rng(4)
    variables = random_variables(rng, JOctAttention(**TINY))
    data, pos = random_inputs(rng, (2, 6))
    out = []
    for p in (0.0, 0.5):
        tm = port_model(variables, dropout=p).train()
        cache = tm.init_cache(2)
        logits = []
        for j in range(6):
            d, q = torch.from_numpy(data[:, j]), torch.from_numpy(pos[:, j])
            lg, qs = tm.decode_step(d, q, cache, j)
            tm.decode_insert(d, q, cache, j, qs)
            logits.append(lg)
        out.append((torch.stack(logits), cache["k"].clone()))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])


# ---- data ---------------------------------------------------------------------------


@pytest.mark.parametrize("start", [0, 5])
def test_octattn_batches_equal_jax_package(tmp_path, start):
    """Two files of different deepest levels (6 and 7: the positions are
    divided by each file's own 2^max_level), two epochs, from step 0 and
    from a mid-epoch step."""
    root = make_shards(tmp_path)
    kw = dict(context_size=64, batch_size=3, seed=5)
    jds, tds = jdata.ShardDataset(root, **kw), tdata.ShardDataset(root, **kw)
    assert tds.mode == jds.mode == "octattn"  # the default of both packages
    spe = tds.steps_per_epoch()
    assert spe == jds.steps_per_epoch() and spe > start
    jg, tg = jds.batches(start_step=start), tds.batches(start_step=start)
    for _ in range(2 * spe):
        jb, tb = next(jg), next(tg)
        for k in ("data", "pos", "label"):
            assert jb[k].dtype == tb[k].dtype and jb[k].shape == tb[k].shape
            assert jb[k].tobytes() == tb[k].tobytes(), k
    assert tb["data"].shape == (3, 64, 4, 3) and tb["pos"].shape == (3, 64, 4, 3)
    assert tb["label"].max() <= 254 and 0 <= tb["pos"].min() and tb["pos"].max() < 1


# ---- the trainer --------------------------------------------------------------------


def _configs(root, extra=()):
    over = [*TINY_OVERRIDES, f"data.root={root}", *extra]
    return (load_config("train_kitti.yaml", CONFIGS, over),
            jload_config("train_kitti.yaml", CONFIGS, over))


def test_trainer_steps_match_jax(tmp_path):
    """Three steps of the port's Trainer against scp_tpu's Trainer (one
    device, f32, p = 0) from the same parameters and batches: the loss of
    each step and the parameters after it."""
    cfg, jcfg = _configs(make_shards(tmp_path))
    ds = tdata.build_dataset(cfg)
    batches = [next(ds.batches(start_step=s)) for s in range(3)]
    jt = jtrainer.Trainer(jcfg, steps_per_epoch=ds.steps_per_epoch())
    state = jt.init_state(batches[0])
    variables = random_variables(np.random.default_rng(6), jt.model)
    state = dataclasses.replace(state, params=jax.device_put(variables["params"], jt.repl))
    tt = ttrainer.Trainer(cfg, steps_per_epoch=ds.steps_per_epoch(), device="cpu")
    tt.init_state()
    weights.load_into(tt.model, variables)
    lr = float(cfg.train.lr)
    start = dict(_leaves(variables["params"]))
    free = {k: np.zeros(v.shape, bool) for k, v in start.items()}
    mu = {k: np.zeros(v.shape, np.float32) for k, v in start.items()}
    n_signed = 0

    def noise(g):
        return np.abs(g) <= NOISE * max(1.0, float(np.abs(g).max()))

    for i, batch in enumerate(batches):
        state, want = jt.train_step(state, batch)
        got = float(tt.train_step(batch))
        assert abs(got - float(want)) <= LOSS_RTOL * abs(float(want)), i
        jmu = dict(_leaves(unfreeze(jax.tree_util.tree_map(np.asarray, state.opt_state[0].mu))))
        for k, g in _leaves(_grads_as_variables(tt.model)):
            jg = (jmu[k] - ttrainer.ADAM_B1 * mu[k]) / (1 - ttrainer.ADAM_B1)  # optax's moment
            exempt = noise(g) & noise(jg) & ((g != 0.0) | (jg != 0.0))
            free[k] |= exempt
            signed = exempt & (np.abs(jg) > SIGN_FLOOR)
            np.testing.assert_array_equal(np.sign(g[signed]), np.sign(jg[signed]),
                                          err_msg=f"{k} at step {i}")
            n_signed += int(signed.sum())
        mu = jmu
        tparams = dict(_leaves(weights.to_variables(tt.model)["params"]))
        jparams = dict(_leaves(unfreeze(jax.tree_util.tree_map(np.asarray, state.params))))
        for k, w in jparams.items():
            f = free[k]
            bound = GRAD_TOL * max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(tparams[k][~f], w[~f], atol=bound, rtol=GRAD_TOL,
                                       err_msg=f"{k} after step {i}")
            for v in (tparams[k], w):
                assert np.abs(v - start[k])[f].max(initial=0.0) <= (i + 1) * lr * (1 + 1e-5), k
    assert all(free[k].all() for k in free if k.endswith("attn/key/bias"))
    n_free = sum(int(f.sum()) for f in free.values())
    assert n_free <= 0.02 * sum(f.size for f in free.values()), n_free
    assert n_signed, "no exempt gradient above SIGN_FLOOR: the sign check saw nothing"


def _tiny_fit_cfg(root, dropout):
    cfg, _ = _configs(root, [f"train.dropout={dropout}", "train.log_every=1"])
    return cfg


def test_fit_with_dropout_resumes_bit_for_bit(tmp_path, deterministic):
    """fit at p = 0.3 for two epochs, against one epoch, then a resume for
    the second: the same parameters and Adam state, bit for bit (the masks
    are a function of (seed, step), so the checkpoint holds no RNG)."""
    cfg = _tiny_fit_cfg(make_shards(tmp_path), 0.3)
    ds = tdata.build_dataset(cfg)
    spe = ds.steps_per_epoch()

    def fit(run, epochs, resume=False):
        t = ttrainer.Trainer(cfg, steps_per_epoch=spe, device="cpu")
        return t.fit(ds, str(tmp_path / run), epochs=epochs, resume=resume)

    straight = fit("straight", 2)
    fit("resumed", 1)
    resumed = fit("resumed", 2, resume=True)
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert straight.step == resumed.step == 2 * spe
    sa, sb = straight.opt.state_dict()["state"], resumed.opt.state_dict()["state"]
    assert all(torch.equal(sa[i]["exp_avg_sq"], sb[i]["exp_avg_sq"]) for i in sa)
    with open(tmp_path / "straight" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == list(range(1, 2 * spe + 1))
    assert all(np.isfinite(r["train_loss"]) for r in recs)
    names = sorted(os.listdir(tmp_path / "straight" / "ckpt"))
    assert names == [f"epoch=0-step={spe}.pt", f"epoch=1-step={2 * spe}.pt", "latest.txt"]


def test_weights_carried_both_ways(tmp_path):
    """A trained port model through save_params_npz into scp_tpu's
    load_params_npz + apply and into the port's load_into (the same
    logits at ATOL), and its trainer checkpoint through the codec CLI's
    load_weights."""
    cfg = _tiny_fit_cfg(make_shards(tmp_path), 0.1)
    ds = tdata.build_dataset(cfg)
    t = ttrainer.Trainer(cfg, steps_per_epoch=2, device="cpu").fit(ds, str(tmp_path / "run"),
                                                                   epochs=1)
    npz = str(tmp_path / "trained.npz")
    tckpt.save_params_npz(npz, t.model)
    jvars = jckpt.load_params_npz(npz)
    assert "batch_stats" not in jvars or not jvars["batch_stats"]
    data, pos, _ = train_batch(np.random.default_rng(7), 1, 64)
    want = np.asarray(JOctAttention(**TINY).apply({"params": jvars["params"]}, data, pos))
    tm = weights.load_into(toct.OctAttention(**TINY, device="cpu"), npz)
    with torch.no_grad():
        got = tm(torch.from_numpy(data), torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    pt = tckpt.latest_checkpoint(str(tmp_path / "run"))
    loaded = load_weights(toct.OctAttention(**TINY, device="cpu"), pt)
    a, b = loaded.state_dict(), t.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_warm_start_from_an_npz_without_batch_stats(tmp_path):
    src = port_model(random_variables(np.random.default_rng(8), JOctAttention(**TINY)))
    npz = str(tmp_path / "pre.npz")
    tckpt.save_params_npz(npz, src)
    cfg, _ = _configs(str(tmp_path / "*.npy"), [f"train.load_pretrain={npz}"])
    t = ttrainer.Trainer(cfg, steps_per_epoch=1, device="cpu")
    t.init_state()
    want = src.layer_0.ffn1.weight.detach().half().float()
    assert torch.equal(t.model.layer_0.ffn1.weight.detach(), want)


# ---- the CLI ------------------------------------------------------------------------


def test_cli_trains_the_default_config(tmp_path):
    """`cli.train` with no --config-name trains train_obj.yaml's
    OctAttention (tiny overrides, device=cpu)."""
    root = make_shards(tmp_path)
    run = str(tmp_path / "run")
    t = tcli.main(["--config-dir", CONFIGS, "--run-dir", run, f"data.root={root}",
                   *TINY_OVERRIDES, "device=cpu", "train.epoch=1", "train.log_every=1",
                   "train.dropout=0.1", "data.val_batches=1"])
    assert isinstance(t.model, toct.OctAttention)
    assert t.model.level_clip_ref == 10 and t.model.dropout == 0.1  # train.type obj
    with open(os.path.join(run, "metrics.jsonl")) as f:
        losses = [json.loads(line)["train_loss"] for line in f]
    assert losses and all(np.isfinite(losses))
    assert tckpt.latest_checkpoint(run) is not None


@pytest.mark.parametrize("flags, want", [([], (False, False, True)),
                                         (["--static-knn", "--pallas-attn",
                                           "--explicit-edgeconv"], (True, True, False))])
def test_cli_passes_the_ehem_flags_it_is_given(tmp_path, monkeypatch, flags, want):
    """On an EHEM config the flags reach the model; a flag not given leaves
    the model's default (static_knn, pallas_attn off; fused EdgeConv on)."""
    monkeypatch.setattr(ttrainer.Trainer, "fit", lambda self, *a, **k: None)
    root = make_shards(tmp_path, bits=(6,), points=500)
    t = tcli.main(["--config-name", "smoke.yaml", "--config-dir", CONFIGS, *flags,
                   f"data.root={root}", "device=cpu", "data.val_batches=0"])
    m = t.model
    assert (m.static_knn, m.pallas_attn, m.geo.conv1.fused) == want
    assert not m.pallas_knn


@pytest.mark.parametrize("flag, switch", [("--static-knn", ("static_knn", True)),
                                          ("--pallas-knn", ("pallas_knn", True)),
                                          ("--pallas-attn", ("pallas_attn", True)),
                                          ("--explicit-edgeconv", ("fused_edgeconv", False))])
def test_cli_refuses_ehem_switches_on_octattention(tmp_path, flag, switch):
    """Each EHEM flag on an OctAttention config is build_model's ValueError,
    naming the switch the flag sets."""
    root = make_shards(tmp_path, bits=(6,), points=500)
    named = f"{switch[0]}={switch[1]}"
    refusal = f"OctAttention takes none of EHEM's switches, got {named}$"
    with pytest.raises(ValueError, match=refusal):
        tcli.main(["--config-name", "train_obj.yaml", "--config-dir", CONFIGS, flag,
                   f"data.root={root}", "device=cpu"])
    cfg, _ = _configs(root)
    with pytest.raises(ValueError, match=named):
        ttrainer.Trainer(cfg, steps_per_epoch=1, device="cpu", **dict([switch]))


def test_profile_train_profiles_the_named_config(tmp_path, monkeypatch):
    """tools.profile_train --config-name: the config with its overrides
    applied, no warm start but the config's own, the batch of the dataset
    cli.train builds; overrides without a config are refused."""
    from scp_tpu_torch.tools import profile_train

    root = make_shards(tmp_path, bits=(6,), points=500)
    monkeypatch.chdir(os.path.dirname(CONFIGS))
    cfg, fixed = profile_train.named_config(
        "train_obj.yaml", ["model.layer_num=1", "data.batch_size=2"], root)
    assert (cfg.model.class_name, cfg.model.layer_num, cfg.data.root) == ("OctAttention", 1, root)
    assert not cfg.train.get("load_pretrain")
    assert fixed["data"].shape[:2] == (2, 1024)
    with pytest.raises(SystemExit):
        profile_train.main(["model.layer_num=1"])
