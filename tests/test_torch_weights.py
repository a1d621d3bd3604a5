"""Weights carried from the JAX package into the port (scp_tpu_torch.weights)."""

import os

import numpy as np
import pytest
import torch

from scp_tpu.train.checkpoints import fuse_qkv_params, load_params_npz
from scp_tpu_torch import weights
from scp_tpu_torch.models.ehem import EHEM

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "ehem_synth_f16_sknn.npz")


@pytest.fixture(scope="module")
def loaded():
    model = EHEM(static_knn=True, device="cpu")
    weights.load_into(model, CKPT)
    return model


def test_every_leaf_consumed_and_every_parameter_filled(loaded):
    with np.load(CKPT) as z:
        n_leaves = len(z.files)
    sd = weights.to_state_dict(weights.read_npz(CKPT))
    assert len(sd) == n_leaves
    assert set(sd) == set(loaded.state_dict())
    for k, v in loaded.state_dict().items():
        torch.testing.assert_close(v, sd[k].to(v.dtype), rtol=0, atol=0, msg=k)


def test_layouts_are_transposed_flax_kernels(loaded):
    with np.load(CKPT) as z:
        k = z["params/swin_self/stage_0/block_0/attn/qkv/kernel"].astype(np.float32)
        emb = z["params/geo/occ_enc/embedding"].astype(np.float32)
        var = z["batch_stats/geo/conv2/bn/var"].astype(np.float32)
    blk = loaded.swin_self.stage_0.block_0
    np.testing.assert_array_equal(blk.attn.qkv.weight.detach().numpy(), k.T)
    np.testing.assert_array_equal(loaded.geo.occ_enc.weight.detach().numpy(), emb)
    np.testing.assert_array_equal(loaded.geo.conv2.bn.running_var.numpy(), var)


def test_nested_dict_source_matches_npz_source(loaded):
    """The JAX package's own loader output (a nested numpy dict) loads to
    the same state as the .npz path."""
    sd_npz = weights.to_state_dict(weights.read_npz(CKPT))
    sd_tree = weights.to_state_dict(weights.fuse_qkv(load_params_npz(CKPT)))
    assert set(sd_npz) == set(sd_tree)
    for k in sd_npz:
        torch.testing.assert_close(sd_tree[k], sd_npz[k], rtol=0, atol=0)


def test_fuse_qkv_matches_jax_migration(rng):
    c = 8
    leaf = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    dense = lambda: {"kernel": leaf(c, c), "bias": leaf(c)}  # noqa: E731
    attn = lambda: {"query": dense(), "key": dense(), "value": dense(),  # noqa: E731
                    "proj": dense(), "rel_pos_bias": leaf(7, 2)}
    tree = {"params": {"swin_self": {"a": attn()}, "swin_cross": {"b": attn()},
                       "oct": {"query": dense(), "key": dense(), "value": dense()}}}
    got = weights.to_state_dict(weights.fuse_qkv(tree))
    want = weights.to_state_dict(fuse_qkv_params(tree))
    assert set(got) == set(want)
    assert "swin_self.a.qkv.weight" in got and "swin_cross.b.kv.weight" in got
    assert "oct.query.weight" in got  # OctAttention-style scopes stay split
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())


def test_bf16_model_rounds_weights_and_keeps_f32_norms():
    """A bf16 model keeps f32 masters (as flax does; an Adam step must be
    able to move them) and rounds each Dense weight to bf16 at use: the
    same bf16 values the codec computed with when it stored them rounded."""
    model = EHEM(static_knn=True, dtype=torch.bfloat16, device="cpu")
    weights.load_into(model, CKPT)
    blk = model.swin_self.stage_0.block_0
    assert blk.mlp1.weight.dtype == torch.float32 and blk.mlp1.kernel().dtype == torch.bfloat16
    with np.load(CKPT) as z:
        k = z["params/swin_self/stage_0/block_0/mlp1/kernel"].astype(np.float32)
    want = torch.from_numpy(np.ascontiguousarray(k.T)).to(torch.bfloat16)
    assert torch.equal(blk.mlp1.kernel(), want)
    assert blk.mlp1.bias.dtype == torch.float32 and blk.norm1.weight.dtype == torch.float32


def test_mismatched_weights_raise():
    model = EHEM(self_depths=(2, 2), cross_depths=(1,), device="cpu")
    with pytest.raises(KeyError, match="missing|unused"):
        weights.load_into(model, CKPT)
