"""The port's OctAttention (scp_tpu_torch/models/octattention.py) held
against scp_tpu's in f32 on the CPU, from the same numpy weights carried
by scp_tpu_torch.weights: the full-window forward and a run of the
lane-batched KV-cache steps (decode_step / decode_insert over 3 lanes x 32
positions, scp_tpu's vmapped over the lanes) at the tiny width of
tests/test_models.py, and one forward of the trained full-width checkpoint
(checkpoints/octattn_synth_l12_v2.npz, all 51 leaves) on a 256-row window.
The model builder (models.build_model) reads configs/train_kitti.yaml."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from scp_tpu.config import load_config as jload_config
from scp_tpu.models.octattention import OctAttention as JOctAttention
from scp_tpu.train.checkpoints import load_params_npz
from scp_tpu_torch import config as tconfig
from scp_tpu_torch import weights
from scp_tpu_torch.models import build_model
from scp_tpu_torch.models.octattention import OctAttention as TOctAttention

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V2 = os.path.join(ROOT, "checkpoints", "octattn_synth_l12_v2.npz")
# tiny width, f32 on both sides: the sums run in other orders (and flax's
# LayerNorm takes E[x^2] - E[x]^2), so logits agree to ~1e-6
ATOL, RTOL = 1e-5, 1e-4
# full width (600-d tokens, K = 600 products): tests/test_torch_models.py's
LOGIT_TOL = 2e-4
TINY = dict(occ_embed_dim=16, level_embed_dim=4, octant_embed_dim=4, abs_pos_embed_dim=8,
            num_layers=2, num_heads=2, hidden_dim=64, context_size=64)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these tests run thousands of small torch ops,
    which crawl when every test worker's thread pool spans all the cores
    (the suite runs several workers on one machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_variables(rng, model):
    """Every leaf drawn from the numpy rng at flax's shapes: kernels
    ~ N(0, 1/fan_in), LayerNorm scales near 1, the rest ~ N(0, 0.2)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            np.zeros((1, 8, 4, 3), np.int32), np.zeros((1, 8, 4, 3), np.float32))

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            v = rng.normal(0.0, 1.0 / np.sqrt(s.shape[0]), s.shape)
        elif name == "scale":
            v = 1.0 + np.abs(rng.normal(0.0, 0.2, s.shape))
        else:
            v = rng.normal(0.0, 0.2, s.shape)
        return v.astype(np.float32)

    return unfreeze(jax.tree_util.tree_map_with_path(leaf, shapes))


def random_inputs(rng, lead, k=4, max_level=12):
    data = np.stack([rng.integers(0, 256, (*lead, k)), rng.integers(0, max_level + 1, (*lead, k)),
                     rng.integers(0, 9, (*lead, k))], axis=-1).astype(np.int32)
    return data, rng.random((*lead, k, 3), dtype=np.float32)


def pair(rng):
    jm = JOctAttention(**TINY)
    variables = random_variables(rng, jm)
    tm = weights.load_into(TOctAttention(**TINY, device="cpu"), variables)
    return jm, variables, tm


def test_forward_matches_jax():
    rng = np.random.default_rng(0)
    jm, variables, tm = pair(rng)
    data, pos = random_inputs(rng, (2, 48))
    want = np.asarray(jm.apply(variables, data, pos))
    with torch.no_grad():
        got = tm(torch.from_numpy(data), torch.from_numpy(pos)).numpy()
    assert got.shape == want.shape == (2, 48, 255)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_kv_cache_steps_match_jax():
    """decode_step / decode_insert over 3 lanes x 32 positions; scp_tpu's
    vmapped over the lanes as its codec runs them.  Each position's input
    row carries its true occupancy for the insert, as the encoder's do."""
    rng = np.random.default_rng(1)
    jm, variables, tm = pair(rng)
    lanes, steps = 3, 32
    data, pos = random_inputs(rng, (lanes, steps))
    step = jax.jit(jax.vmap(lambda d, p, c, t: jm.apply(variables, d, p, c, t,
                                                        method=JOctAttention.decode_step),
                            in_axes=(0, 0, 0, None)))
    insert = jax.jit(jax.vmap(lambda d, p, c, t, q: jm.apply(variables, d, p, c, t, q,
                                                             method=JOctAttention.decode_insert),
                              in_axes=(0, 0, 0, None, 0)))
    jcache = jax.vmap(lambda _: jm.apply(variables, method=JOctAttention.init_cache))(
        jnp.arange(lanes))
    tcache = tm.init_cache(lanes)
    for j in range(steps):
        d, p = data[:, j], pos[:, j]
        want, jqs = step(d, p, jcache, j)
        got, tqs = tm.decode_step(torch.from_numpy(d), torch.from_numpy(p), tcache, j)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL,
                                   err_msg=f"position {j}")
        np.testing.assert_allclose(tqs.numpy(), np.asarray(jqs).transpose(1, 0, 2),
                                   atol=ATOL, rtol=RTOL)
        jcache = insert(d, p, jcache, j, jqs)
        tm.decode_insert(torch.from_numpy(d), torch.from_numpy(p), tcache, j, tqs)
    # the caches hold what scp_tpu's hold: (lanes, L, W, D) there, (L, lanes, h, W, hd) here
    for key in ("k", "v"):
        t = tcache[key][:, :, :, :steps].permute(1, 0, 3, 2, 4).reshape(lanes, 2, steps, -1)
        np.testing.assert_allclose(t.numpy(), np.asarray(jcache[key])[:, :, :steps],
                                   atol=ATOL, rtol=RTOL)


def test_steps_equal_window_forward():
    """Within the port: the KV-cache steps give the full forward's logits
    of the same window (every position sees only the rows before it)."""
    rng = np.random.default_rng(2)
    _, _, tm = pair(rng)
    data, pos = random_inputs(rng, (2, 40))
    with torch.no_grad():
        full = tm(torch.from_numpy(data), torch.from_numpy(pos))
    cache = tm.init_cache(2)
    for j in range(40):
        d, p = torch.from_numpy(data[:, j]), torch.from_numpy(pos[:, j])
        logits, qs = tm.decode_step(d, p, cache, j)
        np.testing.assert_allclose(logits.numpy(), full[:, j].numpy(), atol=ATOL, rtol=RTOL)
        tm.decode_insert(d, p, cache, j, qs)


def test_build_model_from_config():
    cfg = tconfig.load_config("train_kitti.yaml", os.path.join(ROOT, "configs"))
    jcfg = jload_config("train_kitti.yaml", config_dir=os.path.join(ROOT, "configs"))
    tm = build_model(cfg, device="cpu")
    jm = JOctAttention.from_config(jcfg)
    assert isinstance(tm, TOctAttention)
    assert (tm.embed_dim, tm.num_layers, tm.num_heads, tm.context_size, tm.level_clip_ref) == (
        jm.embed_dim, jm.num_layers, jm.num_heads, jm.context_size, jm.level_clip_ref) == (
        600, 3, 4, 1024, 12)
    assert tm.layers[0].ffn1.weight.shape == (300, 600)
    assert tm.decoder1.weight.shape == (255, 600) and tm.occ_enc.weight.shape == (256, 128)
    cfg.train.type = "obj"
    assert build_model(cfg, device="cpu").level_clip_ref == 10
    with pytest.raises(ValueError, match="switches"):
        build_model(cfg, device="cpu", static_knn=True)


def test_full_width_checkpoint_matches_jax():
    """octattn_synth_l12_v2.npz (float16 leaves, read as f32) into both
    packages; one 256-row window of real-looking context rows."""
    tm = weights.load_into(TOctAttention(device="cpu"), V2)
    assert len(tm.state_dict()) == 51
    jm = JOctAttention()
    variables = load_params_npz(V2)
    rng = np.random.default_rng(3)
    data, pos = random_inputs(rng, (1, 256))
    data[..., 1] = np.sort(rng.integers(1, 13, (1, 256, 4)), axis=-1)  # ancestors shallower
    want = np.asarray(jm.apply(variables, data, pos))
    with torch.no_grad():
        got = tm(torch.from_numpy(data), torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)
