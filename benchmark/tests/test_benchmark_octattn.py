"""The OctAttention cell on the CPU: its closed-form products against
torch's FlopCounterMode on the plain reference, the reference's window rows
against the port's level slices, the rehearsal (a few thousand points at
L8, narrow widths) reading `correct: true` with its per-layer metrics, a
fault each that `correct` must catch, the readers on a record without the
program's spans (a program that records none), and the rehearsal in a
process where JAX cannot load."""

import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import run
from benchmark.harness import octattn as products
from benchmark.harness import registry
from benchmark.reference.octattention import Reference, fresh_params, level_rows
from benchmark.reference.octree import Octree, kitti_qs, spherical_grid
from benchmark.harness.synth import seed_rng, synth_sweep

CELL = "octattn-l12-sweeps"
WIDTHS = registry.config("octattn-l12")["rehearsal"]["widths"]
SEED = "2147483777"


@pytest.mark.parametrize("m", [1, 17, 32])
def test_window_products_match_flop_counter(m):
    params = fresh_params(WIDTHS, torch.Generator().manual_seed(1), "cpu")
    g = torch.Generator().manual_seed(2)
    data = torch.stack([torch.randint(0, 255, (1, m, 4), generator=g),
                        torch.randint(0, 13, (1, m, 4), generator=g),
                        torch.randint(0, 9, (1, m, 4), generator=g)], -1)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        Reference(params, WIDTHS).forward(data, torch.rand((1, m, 4, 3), generator=g))
    assert fc.get_total_flops() == products.window_products(WIDTHS, m, causal=False)
    # the causal count keeps what a real node's query needs: fewer keys
    assert products.window_products(WIDTHS, m) <= products.window_products(WIDTHS, m, False)


def test_level_products_cut_a_level_into_windows():
    one = products.window_products(WIDTHS, 32)
    assert products.level_products(WIDTHS, 32, 32) == one
    assert products.level_products(WIDTHS, 70, 32) == 2 * one + products.window_products(
        WIDTHS, 6)
    assert products.mfu_f32(products.PEAK_F32_FLOPS, 1.0) == pytest.approx(100.0)
    assert products.mfu_f32(1.0, 0.0) is None


def test_reference_rows_are_the_ports_level_slices():
    from scp_tpu_torch.codec.octattn_codec import OctAttentionCodec
    from scp_tpu_torch.core.preprocess import kitti_qs as port_qs
    from scp_tpu_torch.core.preprocess import preprocess_points

    pts = synth_sweep(seed_rng(11, 0), 3000).astype(np.float32)
    tree = Octree(spherical_grid(pts, kitti_qs(9)))
    rows = preprocess_points(pts, system="spher", qs=port_qs(9)).context
    levels, occ, _ = OctAttentionCodec.split_levels(rows)
    assert len(levels) == len(tree.sizes)
    for li, (data, pos) in enumerate(levels):
        want_d, want_p, want_y = level_rows(tree, li)
        np.testing.assert_array_equal(data, want_d)
        np.testing.assert_array_equal(pos, want_p)
    np.testing.assert_array_equal(occ, tree.symbols())


def _run(capsys, *extra, trace="0"):
    rc = run.main(["--workload", CELL, "--seed", SEED, "--seconds", "0.5", "--trace", trace,
                   "--rehearse", *extra])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_rehearsal_reads_correct_with_its_metrics(capsys):
    result = _run(capsys, trace="1")
    assert result["correct"] is True, result["checks"]
    assert set(result["checks"]) == {"octree_diff", "decode_diff", "context_diff",
                                     "p_gap_bits"}
    for name in ("preprocess_ms.p50", "encode_ms.p50", "decode_ms.p50", "position_ms.octattn",
                 "launches_per_position.octattn", "mfu.octattn", "idle_share.sweeps"):
        assert name in result["metrics"], name


@pytest.mark.parametrize("fault,number", [("altered_symbol", "decode_diff"),
                                          ("perturbed_cache_row", "p_gap_bits")])
def test_fault_reads_incorrect(capsys, fault, number):
    result = _run(capsys, "--fault", fault)
    assert result["correct"] is False
    check = result["checks"][number]
    assert check["value"] > check["limit"], result["checks"]


def test_control_reads_incorrect(capsys):
    result = _run(capsys, "--control")
    assert result["checks"]["p_gap_bits"]["value"] > result["checks"]["p_gap_bits"]["limit"]


def test_readers_are_silent_without_the_programs_spans():
    record = {"window_s": 10.0, "chips": 1, "spans": {}, "products": {}, "program": {
        "spans": [], "counters": {}}, "probe": {"spans": [], "counters": {}}, "traces": None}
    for name in ("position_ms.octattn", "launches_per_position.octattn", "mfu.octattn"):
        assert registry.metric_reader(name)(record) is None, name
        assert registry.metric_reader(name)({"window_s": 1.0}) is None, name


def test_rehearsal_loads_no_jax():
    from test_benchmark_isolation import FORBIDDEN, _child

    out = _child(["--workload", CELL, "--seed", SEED, "--seconds", "1", "--trace", "0",
                  "--rehearse"])
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert not set(json.loads(lines[-1].split(" ", 1)[1])) & FORBIDDEN
    assert json.loads(lines[-2])["correct"] is True, out.stderr[-3000:]
