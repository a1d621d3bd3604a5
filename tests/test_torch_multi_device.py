"""Launches on the operands' card and data-parallel training over cards.

The kernels' launchers run on the CUDA runtime's current device, so every
wrapper makes the operands' card current for its launch
(ops/_cuda.py::on_device).  On two cards or more (marker `cuda`; they
skip below two), kernels A-E launch on cuda:1 while cuda:0 is current and
are held against their plain versions, and a 2-card NCCL training step
against the 1-card step on the same global batch.  The check that
operands on two devices are refused runs here.  This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_multi_device.py
"""

import os

import numpy as np
import pytest
import torch

from scp_tpu_torch.ops import _cuda
from scp_tpu_torch.ops import knn_topk as tknn
from scp_tpu_torch.ops import mlp as tmlp
from scp_tpu_torch.ops import swin_attn as tswin
from scp_tpu_torch.ops import window_attn as twattn

TOL = 3e-2  # bf16 outputs (tests/test_torch_kernels.py)
LOSS_RTOL = 1e-5  # f32 step, summation order only (tests/test_torch_train_step.py)
GRAD_TOL = 1e-4  # x max(1, the leaf's largest magnitude)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs: a launch on the second card while the first "
                    "is current")
    return torch.device("cuda:1")


def test_operands_on_two_devices_are_refused():
    with pytest.raises(ValueError, match="one CUDA device expected"):
        _cuda.on_device(torch.zeros(2), torch.zeros(2, device="meta"))
    with pytest.raises(ValueError, match="one CUDA device expected"):
        _cuda.on_device(None)


@pytest.mark.cuda
def test_kernels_a_to_e_launch_on_the_second_card_while_the_first_is_current(two_cards):
    dev = two_cards
    g = torch.Generator(device=dev).manual_seed(0)

    def r(*s, scale=1.0):
        return torch.randn(*s, generator=g, device=dev) * scale

    c, f, w, h, bn = 256, 1024, 512, 4, 2
    mask = torch.where(torch.rand(1, w, w, generator=g, device=dev) < 0.1, -100.0, 0.0)
    x, qs = r(bn, w, c).bfloat16(), r(bn, w, c).bfloat16()
    ln = (1 + r(c, scale=0.1), r(c, scale=0.1))
    rel = r(h, w, w, scale=0.2)
    wp, bp = r(c, c, scale=0.05).bfloat16(), r(c, scale=0.05)
    cases = {
        "A": (tmlp.ln_mlp_residual, tmlp.ln_mlp_residual_plain,
              (x.reshape(-1, c), *ln, r(f, c, scale=0.05).bfloat16(), r(f, scale=0.05),
               r(c, f, scale=0.05).bfloat16(), r(c, scale=0.05), 1e-5, "gelu")),
        "B": (tswin.attn_sublayer_self, tswin.attn_sublayer_self_plain,
              (x, *ln, r(3 * c, c, scale=0.05).bfloat16(), r(3 * c, scale=0.05), rel, mask,
               wp, bp, h, 1e-5)),
        "C": (tswin.attn_sublayer_cross, tswin.attn_sublayer_cross_plain,
              (x, qs, *ln, r(c, c, scale=0.05).bfloat16(), r(c, scale=0.05),
               r(2 * c, c, scale=0.05).bfloat16(), r(2 * c, scale=0.05), rel, mask, wp, bp, h,
               1e-5)),
        "E": (twattn.window_attention, twattn.window_attention_plain,
              (r(bn, h, w, 64).bfloat16(), r(bn, h, w, 64).bfloat16(),
               r(bn, h, w, 64).bfloat16(), rel, mask, 0.125)),
    }
    with torch.cuda.device(0):
        assert torch.cuda.current_device() == 0
        for name, (fn, plain, args) in cases.items():
            n0 = fn.launches
            got = fn(*args)
            torch.cuda.synchronize(dev)
            assert fn.launches == n0 + 1 and got.device == dev, name
            torch.testing.assert_close(got.float(), plain(*args).float(), atol=TOL, rtol=TOL,
                                       msg=name)
        pts = torch.from_numpy(np.random.default_rng(0).integers(0, 4096, (2, 2048, 3))
                               ).float().to(dev).contiguous()
        got = tknn.knn_topk(pts, 20)
        torch.cuda.synchronize(dev)
        assert torch.equal(got, tknn.knn_topk_plain(pts, 20)), "D"
        assert torch.cuda.current_device() == 0
    with pytest.raises(ValueError, match="one CUDA device expected"):
        tmlp.ln_mlp_residual(*cases["A"][2][:1], *(t.to("cuda:0") for t in cases["A"][2][1:7]),
                             1e-5, "gelu")


def _tiny_step_specs(tmp, device):
    """A narrow EHEM whose Swin runs kernels B and C (configs/
    train_kitti_ehem.yaml with a 128-wide Swin of 64-node windows, f32)
    from a seeded init, one global batch of two 128-node contexts whose
    rows differ in their statistics."""
    from scp_tpu_torch.config import Config
    from scp_tpu_torch.models import build_model
    from scp_tpu_torch.models.layers import flax_init_
    from scp_tpu_torch.tools import dryrun_multichip as dry

    cfg = dry.tiny_config(2)
    cfg.model.swin = Config.wrap(dict(embed_dim=128, self_depths=[2, 2], cross_depths=[2, 1],
                                      num_heads=4, window_size=64, mlp_ratio=2.0))
    model = build_model(cfg, torch.float32, device="cpu", static_knn=True)
    flax_init_(model, torch.Generator().manual_seed(3))
    state = os.path.join(tmp, "state.pt")
    torch.save(model.state_dict(), state)
    data, pos, label = dry.example_batch(np.random.default_rng(0), 128, batch=2)
    pos[1] = 0.6 + 0.25 * pos[1]
    return dict(cfg=cfg.to_plain(), state=state, device=device, switches={"static_knn": True},
                batches=[{"data": data, "pos": pos, "label": label}])


@pytest.mark.cuda
def test_two_card_nccl_step_equals_the_one_card_step(two_cards, tmp_path):
    from scp_tpu_torch.tools import dryrun_multichip as dry
    from scp_tpu_torch.train import distributed

    spec = _tiny_step_specs(str(tmp_path), "cuda")
    one = dry.step_worker(spec)
    r0, r1 = distributed.run_workers(dry.step_worker, 2, args=(spec,), backend="nccl",
                                     workdir=str(tmp_path / "rdzv"), timeout_s=600)
    assert (r0["device"], r1["device"]) == ("cuda:0", "cuda:1")
    assert r0["loss"] == r1["loss"]
    assert abs(r0["loss"] - one["loss"]) <= LOSS_RTOL * abs(one["loss"])
    assert all(r["launches"]["A"] and r["launches"]["B"] and r["launches"]["C"]
               for r in (r0, r1))
    for k, g in one["grads"].items():
        tol = GRAD_TOL * max(1.0, float(g.abs().max()))
        torch.testing.assert_close(r0["grads"][k], g, atol=tol, rtol=GRAD_TOL, msg=k)
    assert r0["params_sha256"] == r1["params_sha256"]
    for k, b in one["buffers"].items():
        torch.testing.assert_close(r1["buffers"][k], b, atol=1e-5, rtol=1e-5, msg=k)
