"""The reference-checkpoint importer of the port
(scp_tpu_torch/tools/import_torch_ckpt.py) against scp_tpu's.

Reference state_dicts are made by chip_smoke.reference_state_dict, the
inverse of the importer's rules (it splits the fused q|k|v, transposes
kernels to torch's (out, in), gives 1x1 convs their (F, C, 1, 1) form and
adds the buffers the importer skips).  The mapping only moves values, so
every comparison is exact."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from scp_tpu.tools import import_torch_ckpt as jax_import  # noqa: E402
from scp_tpu_torch import weights  # noqa: E402
from scp_tpu_torch.models.ehem import EHEM  # noqa: E402
from scp_tpu_torch.models.octattention import OctAttention  # noqa: E402
from scp_tpu_torch.tools import import_torch_ckpt as port_import  # noqa: E402

CKPTS = {"ehem": os.path.join(ROOT, "checkpoints", "ehem_synth_f16_sknn.npz"),
         "octattention": os.path.join(ROOT, "checkpoints", "octattn_synth_l12_v2.npz")}
NARROW = {"ehem": dict(self_depths=(2, 1), cross_depths=(1, 1), embed_dim=64, num_heads=2,
                       window_size=16, mlp_ratio=2.0, knn_k=4),
          "octattention": dict(occ_embed_dim=16, level_embed_dim=4, octant_embed_dim=4,
                               abs_pos_embed_dim=8, num_layers=2, num_heads=2, hidden_dim=64,
                               context_size=32)}


class NotAllowlisted:
    """A class outside torch.load's weights_only allowlist."""


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (see tests/test_torch_profile_tools.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _narrow_model(name):
    cls = EHEM if name == "ehem" else OctAttention
    model = cls(device="cpu", **NARROW[name])
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, t in model.state_dict().items():  # storage shared with the model
            if name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
            elif t.dtype.is_floating_point:
                t.copy_(torch.randn(t.shape, generator=gen) * 0.05)
    return model


@pytest.fixture(scope="module")
def sources():
    """{(model, width): flat flax-layout tree} for both models, narrow
    (randomized every leaf) and full width (the checkpoints, in memory)."""
    out = {}
    for name, path in CKPTS.items():
        with np.load(path) as z:
            out[(name, "full")] = {k: z[k] for k in z.files}
        out[(name, "narrow")] = port_import.flatten(
            weights.to_variables(_narrow_model(name)))
    return out


def _flat_f32(tree):
    return {k: np.asarray(v, np.float32) for k, v in port_import.flatten(tree).items()}


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        a, b = np.asarray(got[k], np.float32), np.asarray(want[k], np.float32)
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32), err_msg=k)


CASES = [(m, w) for m in ("ehem", "octattention") for w in ("narrow", "full")]


@pytest.mark.parametrize("model,width", CASES)
def test_port_import_equals_scp_tpus(sources, model, width):
    sd = chip_smoke.reference_state_dict(sources[(model, width)], model)
    assert any("num_batches_tracked" in k or k == "mask" for k in sd)  # skipped buffers there
    _assert_same(_flat_f32(port_import.import_state_dict(sd, model)),
                 _flat_f32(jax_import.import_state_dict(sd, model)))


@pytest.mark.parametrize("model,width", CASES)
def test_scp_tpu_import_of_the_inverse_is_the_source(sources, model, width):
    """The inverse is right: scp_tpu's own importer gives the tree back."""
    flat = sources[(model, width)]
    sd = chip_smoke.reference_state_dict(flat, model)
    _assert_same(_flat_f32(jax_import.import_state_dict(sd, model)), flat)


@pytest.mark.parametrize("model,width", CASES)
def test_verify_tree_passes_in_both_packages(sources, model, width):
    sd = chip_smoke.reference_state_dict(sources[(model, width)], model)
    kw = NARROW[model] if width == "narrow" else {}
    jax_import.verify_tree(jax_import.import_state_dict(sd, model), model, kw)
    loaded = port_import.verify_tree(port_import.import_state_dict(sd, model), model, kw,
                                     device="cpu")
    assert loaded.device.type == "cpu"


def test_verify_tree_raises_on_a_missing_unused_or_misshapen_leaf(sources):
    variables = port_import.import_state_dict(
        chip_smoke.reference_state_dict(sources[("octattention", "narrow")], "octattention"),
        "octattention")
    kw = NARROW["octattention"]
    missing = {"params": {k: v for k, v in variables["params"].items() if k != "decoder1"}}
    unused = {"params": {**variables["params"], "extra": {"bias": np.zeros(3, np.float32)}}}
    params = dict(variables["params"])
    params["decoder1"] = {**params["decoder1"], "bias": np.zeros(7, np.float32)}
    for bad in (missing, unused, {"params": params}):
        with pytest.raises(ValueError, match="import mismatch"):
            port_import.verify_tree(bad, "octattention", kw, device="cpu")


@pytest.mark.parametrize("model", ["ehem", "octattention"])
def test_an_unmapped_key_raises_in_both_packages(sources, model):
    sd = chip_smoke.reference_state_dict(sources[(model, "narrow")], model)
    sd["head.extra.weight"] = torch.zeros(2, 2)
    for pkg in (port_import, jax_import):
        with pytest.raises(ValueError, match="unmapped reference keys"):
            pkg.import_state_dict(sd, model)


@pytest.mark.parametrize("model", ["ehem", "octattention"])
def test_imported_weights_give_the_sources_logits(sources, model):
    src = _narrow_model(model)
    sd = chip_smoke.reference_state_dict(port_import.flatten(weights.to_variables(src)), model)
    got = weights.load_into((EHEM if model == "ehem" else OctAttention)(
        device="cpu", **NARROW[model]), port_import.import_state_dict(sd, model))
    rng = np.random.default_rng(0)
    n = 32
    if model == "ehem":
        data = torch.from_numpy(rng.integers(1, 9, (2, n, 4, 3)))
        pos = torch.from_numpy(rng.random((2, n, 3), dtype=np.float32))
        want, out = src.decode_phase1(data, pos)[0], got.decode_phase1(data, pos)[0]
    else:
        data = torch.from_numpy(np.stack([rng.integers(0, 255, (2, n, 4)),  # occ, level, octant
                                          rng.integers(1, 12, (2, n, 4)),
                                          rng.integers(0, 9, (2, n, 4))], -1))
        pos = torch.from_numpy(rng.random((2, n, 4, 3), dtype=np.float32))
        with torch.no_grad():
            want, out = src(data, pos), got(data, pos)
    assert torch.isfinite(want).all()
    assert torch.equal(out, want)


def _lightning(path, sd, extra=None):
    torch.save({"state_dict": sd, "epoch": 0, "global_step": 0, **(extra or {})}, path)


@pytest.mark.parametrize("model,width", [("ehem", "narrow"), ("octattention", "full")])
def test_cli_writes_scp_tpus_npz(sources, tmp_path, model, width):
    """Narrow EHEM without the structure check, full-width OctAttention with it."""
    ckpt = tmp_path / "ref.ckpt"
    _lightning(ckpt, chip_smoke.reference_state_dict(sources[(model, width)], model))
    flags = ["--no_verify"] if width == "narrow" else []
    argv = ["--ckpt", str(ckpt), "--model", model, *flags]
    port_import.main(argv + ["--out", str(tmp_path / "port.npz"), "--device", "cpu"])
    jax_import.main(argv + ["--out", str(tmp_path / "jax.npz")])
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype == np.float32, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the port's npz loads through the port's own reader
    if width == "full":
        weights.load_into(OctAttention(device="cpu"), str(tmp_path / "port.npz"))


def test_cli_refuses_an_unsafe_pickle_without_trust_pickle(sources, tmp_path):
    ckpt = tmp_path / "meta.ckpt"
    sd = chip_smoke.reference_state_dict(sources[("ehem", "narrow")], "ehem")
    _lightning(ckpt, sd, {"hyper_parameters": NotAllowlisted()})
    argv = ["--ckpt", str(ckpt), "--model", "ehem", "--no_verify"]
    for pkg, extra in ((port_import, ["--device", "cpu"]), (jax_import, [])):
        with pytest.raises(SystemExit, match="--trust_pickle"):
            pkg.main(argv + extra + ["--out", str(tmp_path / "refused.npz")])
    assert not (tmp_path / "refused.npz").exists()
    out = tmp_path / "trusted.npz"
    port_import.main(argv + ["--device", "cpu", "--trust_pickle", "--out", str(out)])
    with np.load(out) as z:
        _assert_same({k: z[k] for k in z.files}, sources[("ehem", "narrow")])
