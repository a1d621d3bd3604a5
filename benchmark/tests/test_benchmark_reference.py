"""The plain reference against the port's plain path on the CPU, at a tiny
size: the octree and contexts, the entropy model's two phases, and a
training step.  The test imports both; the reference modules import
nothing of the port (test_benchmark_isolation.py)."""

import numpy as np
import pytest
import torch

from benchmark.harness.synth import seed_rng, synth_sweep
from benchmark.reference.ehem import Reference, fresh_params
from benchmark.reference.octree import Octree, SweepContexts, kitti_qs, spherical_grid

WIDTHS = {"embed_dim": 256, "num_heads": 4, "window_size": 16, "mlp_ratio": 1.0,
          "self_depths": [1, 1], "cross_depths": [1, 1], "token_num": 255, "max_level": 19}


@pytest.fixture(scope="module")
def sweep():
    pts = synth_sweep(seed_rng(11, 0), 4000)
    return pts, Octree(spherical_grid(pts, kitti_qs(11)))


def test_octree_and_contexts_match_the_port(sweep):
    from scp_tpu_torch.codec.slices import split_levels
    from scp_tpu_torch.core.preprocess import kitti_qs as port_qs
    from scp_tpu_torch.core.preprocess import preprocess_points

    pts, tree = sweep
    res = preprocess_points(pts, system="spher", qs=port_qs(11))
    sl = split_levels(res.context, angular=True)
    assert sl.level_sizes == tree.sizes
    np.testing.assert_array_equal(sl.occ_stream, tree.symbols())
    np.testing.assert_array_equal(np.concatenate(sl.data)[:, :3], tree.contexts()[:, :3])
    np.testing.assert_array_equal(np.concatenate(sl.pos_int), tree.pos)
    np.testing.assert_array_equal(res.context, tree.shard())


def _port_model(params, stats, static_knn):
    from scp_tpu_torch.models.ehem import EHEM
    from scp_tpu_torch.weights import load_into

    nested = {}
    for coll, flat in (("params", params), ("batch_stats", stats)):
        for path, t in flat.items():
            node = nested.setdefault(coll, {})
            *scope, leaf = path.split("/")
            for s in scope:
                node = node.setdefault(s, {})
            node[leaf] = t.numpy()
    w = WIDTHS
    model = EHEM(token_num=w["token_num"], max_level=w["max_level"],
                 self_depths=tuple(w["self_depths"]), cross_depths=tuple(w["cross_depths"]),
                 embed_dim=w["embed_dim"], num_heads=w["num_heads"],
                 window_size=w["window_size"], mlp_ratio=w["mlp_ratio"],
                 static_knn=static_knn, device="cpu")
    return load_into(model, nested)


def test_position_graphs_differ_only_on_near_ties(sweep):
    """The reference's exact float64 graph and the port's float32 one
    (ties to the lower index in both) may swap a neighbor only where the
    k-th and (k+1)-th distances tie to float32 rounding of the score
    2 q.k - |q|^2 - |k|^2 (positions in [0, 1]: about 1e-6).  On a grid,
    exact ties are common, so the share of such rows is not small."""
    from scp_tpu_torch.ops.knn import knn_indices

    _, tree = sweep
    wins = [w for w in SweepContexts(tree, 256).windows() if w[3].shape[0] == 256]
    p = torch.from_numpy(np.stack([w[4] for w in wins]))
    a = torch.sort(Reference.knn(None, p, 20), -1).values
    b = torch.sort(knn_indices(p, 20), -1).values
    bad = (a != b).any(-1)
    d = ((p.double()[:, :, None] - p.double()[:, None]) ** 2).sum(-1)
    kth = torch.sort(d, -1).values
    assert bool(((kth[..., 20] - kth[..., 19])[bad] <= 1e-6).all())


@pytest.mark.parametrize("static_knn", [True, False])
def test_model_phases_match_the_port(sweep, static_knn, monkeypatch):
    """On the port's own graphs (the graphs are held apart above), the
    reference's logits of both phases agree with the port's plain path."""
    from scp_tpu_torch.ops.knn import knn_indices

    monkeypatch.setattr(Reference, "knn", lambda self, f, k: knn_indices(f.float(), k))
    _, tree = sweep
    params, stats = fresh_params(WIDTHS, torch.Generator().manual_seed(3), "cpu")
    for k in stats:  # running statistics away from (0, 1), as a trained model has
        stats[k] = stats[k] + 0.1 * torch.rand(stats[k].shape, generator=torch.Generator()
                                               .manual_seed(4))
    ref = Reference(params, stats, WIDTHS, static_knn)
    port = _port_model(params, stats, static_knn)
    wins = [w for w in SweepContexts(tree, 256).windows() if w[3].shape[0] == 256][-3:]
    d = torch.from_numpy(np.stack([w[3] for w in wins]))
    p = torch.from_numpy(np.stack([w[4] for w in wins]))
    y = torch.from_numpy(np.stack([w[5] for w in wins]).astype(np.int64))
    with torch.no_grad():
        r1, f1, f2 = ref.phase1(d, p)
        r2 = ref.phase2(f1, f2, y[:, 0::2])
    q1, g1, g2 = port.decode_phase1(d, p)
    q2 = port.decode_phase2(g1, g2, y[:, 0::2], False)
    torch.testing.assert_close(q1, r1, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(q2, r2, atol=1e-4, rtol=1e-4)


def test_training_step_matches_the_port(tmp_path, monkeypatch):
    """The benchmark's training runner in float32 on the CPU
    (the port's data pipeline and trainer) against the reference's steps,
    on the port's graphs."""
    from scp_tpu_torch.ops.knn import knn_indices

    from benchmark.checks.train import gaps, leaf_map
    from benchmark.runners.train import make_shards, train_main
    from benchmark.reference.train import global_batch, reference_steps

    shards = make_shards(str(tmp_path), 5, 1, 3000, 10)
    params, stats = fresh_params(WIDTHS, torch.Generator().manual_seed(6), "cpu")
    wpath = str(tmp_path / "w.npz")
    np.savez(wpath, **{f"params/{k}": v.numpy() for k, v in params.items()},
             **{f"batch_stats/{k}": v.numpy() for k, v in stats.items()})
    traffic = {"batch": 2, "context": 256, "lr": 1e-4, "checked": 2, "traced": 1}
    config = {"widths": WIDTHS, "dtype": "float32", "static_knn": True, "pallas_knn": False,
              "pallas_attn": False}
    p = {"config": config, "traffic": traffic, "seed": 5, "seconds": 0.0, "trace": False,
         "rehearse": True, "root": str(__import__("benchmark").__path__[0] + "/.."),
         "weights_path": wpath, "fault": None}
    out = train_main(p, str(tmp_path))
    loaded = [np.load(f, mmap_mode="r") for f in shards]
    batches = [global_batch(loaded, 256, 2, 5, s) for s in range(2)]
    for (d, pos, lab), got in zip(batches, out["batches"]):
        np.testing.assert_array_equal(got[0], d)
        np.testing.assert_array_equal(got[1], pos)
        np.testing.assert_array_equal(got[2], lab)
    monkeypatch.setattr(Reference, "knn", lambda self, f, k: knn_indices(f.float(), k))
    ref = reference_steps(dict(params), stats, WIDTHS, True, batches, 1e-4, "cpu", block=1)
    names = leaf_map(out["g1"], ref[1])
    prog = (out["losses"], {names[n]: v for n, v in out["g1"].items()},
            {names[n]: v for n, v in out["change"].items()})
    g = gaps(*prog, *ref)
    assert g["loss_gap"] < 1e-5
    assert g["grad_gap"] < 1e-3
    assert g["change_gap"] < 1e-2
