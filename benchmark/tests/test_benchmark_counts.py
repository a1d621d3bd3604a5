"""The frozen closed forms (harness/products.py) against torch's
FlopCounterMode on the benchmark's own plain reference, at a small size on
the CPU: a window whose every Swin stage tiles the attention window, so
that the reference computes no padding."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import products
from benchmark.reference.ehem import Reference, fresh_params

WIDTHS = {"embed_dim": 256, "num_heads": 4, "window_size": 8, "mlp_ratio": 1.0,
          "self_depths": [2, 2], "cross_depths": [1, 1], "token_num": 255, "max_level": 19}


def _window(m, seed=0):
    g = torch.Generator().manual_seed(seed)
    data = torch.zeros((1, m, 4, 3), dtype=torch.int32)
    data[..., 0] = torch.randint(1, 12, (1, m, 4), generator=g)
    data[..., 1] = torch.randint(1, 9, (1, m, 4), generator=g)
    data[..., 2] = torch.randint(0, 255, (1, m, 4), generator=g)
    pos = torch.rand((1, m, 3), generator=g)
    return data, pos


@pytest.mark.parametrize("static_knn", [True, False])
def test_window_products_match_flop_counter(static_knn):
    m = 64
    params, stats = fresh_params(WIDTHS, torch.Generator().manual_seed(1), "cpu")
    ref = Reference(params, stats, WIDTHS, static_knn)
    data, pos = _window(m)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        ref.forward(data, pos)
    assert fc.get_total_flops() == products.total(
        products.window_products(WIDTHS, static_knn, m))


def test_kernel_work_covers_the_swin_and_knn_products():
    m = 64
    parts = products.window_products(WIDTHS, False, m)
    merges = 2 * (m // 2) * 512 * 256 + 2 * 2 * (m // 4) * 512 * 256
    swin = products.swin_kernel_work(WIDTHS, m, m)
    assert sum(o for o, _ in swin) == parts["swin_self"] + parts["swin_cross"] - merges
    assert products.knn_kernel_work(False, m, m) == []  # under D's 2,048 rows
    knn = products.knn_kernel_work(False, m, 4096)
    assert sum(o for o, _ in knn) == parts["knn"]


def test_shares_stay_in_range():
    assert products.mfu_share(989e12, 1.0) == pytest.approx(100.0)
    assert products.mfu_share(1.0, 0.0) is None
    assert products.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert products.least_seconds(0, 3.35e12) == pytest.approx(1.0)
