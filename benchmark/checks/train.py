"""`correct` for the training traffic: the program's first steps, run in
set-up through the window's own call and feed, against the plain reference
(reference/train.py) from the same weights on the same rows.

Numbers compared (limits in limits/<cell>.json):
  batch_diff   entries of the batches the program's data pipeline fed
               that differ from the reference's derivation from the shards
               (exact, 0);
  loss_gap     the largest over the checked steps of |loss_program -
               loss_reference| / loss_reference;
  grad_gap     the worst leaf's |norm of the first gradient as the
               program's Adam got it (its first moment after one step /
               (1 - b1)) - the reference's norm|, over the larger of the
               reference leaf's norm and the median leaf's;
  change_gap   the same for the norm of each parameter's change after the
               checked steps.
Leaves whose reference gradient is under a thousandth of the median leaf's
move under Adam by rounding alone and are left out of both leaf numbers.
The worst leaf's name and the median leaf's gaps are printed beside them.
"""

from __future__ import annotations

import sys

import numpy as np

from benchmark.reference.ehem import exact_f32
from benchmark.reference.train import global_batch, reference_steps

TINY_GRADIENT = 1e-3  # of the median leaf's reference gradient norm


def leaf_map(names, ref_keys) -> dict:
    """Program parameter names (module path + leaf) -> reference paths."""
    ref = set(ref_keys)
    out = {}
    for n in names:
        *scope, leaf = n.split(".")
        base = "/".join(scope)
        cands = [f"{base}/{leaf}"] + ([f"{base}/{x}" for x in ("kernel", "embedding", "scale")]
                                      if leaf == "weight" else [])
        hit = [c for c in cands if c in ref]
        if len(hit) != 1:
            raise KeyError(f"parameter {n} matches {hit or 'no'} reference leaf")
        out[n] = hit[0]
    return out


def leaf_gaps(prog: dict, ref: dict, keep) -> dict:
    scale = float(np.median([ref[k] for k in keep]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], scale) for k in keep}


def gaps(prog_losses, prog_g1, prog_change, ref_losses, ref_g1, ref_change) -> dict:
    """The step numbers from the two sides' readings (dicts keyed by
    reference path): the compared ones (worst leaves), the worst leaves'
    names and the median leaves' gaps."""
    med = float(np.median(list(ref_g1.values())))
    keep = [k for k in ref_g1 if ref_g1[k] >= TINY_GRADIENT * med]
    g, c = leaf_gaps(prog_g1, ref_g1, keep), leaf_gaps(prog_change, ref_change, keep)
    worst_g, worst_c = max(g.items(), key=lambda kv: kv[1]), max(c.items(), key=lambda kv: kv[1])
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog_losses, ref_losses)),
            "grad_gap": worst_g[1], "change_gap": worst_c[1],
            "worst_grad": worst_g[0], "worst_change": worst_c[0],
            "median_grad": float(np.median(list(g.values()))),
            "median_change": float(np.median(list(c.values())))}


def compare(ctx, shard_paths, lead) -> list:
    lim = ctx.limits()
    tr = ctx.traffic
    shards = [np.load(f, mmap_mode="r") for f in sorted(shard_paths)]
    seed = int(ctx.seed) % (1 << 63)
    ref_batches, batch_diff = [], 0
    for s in range(tr["checked"]):
        want = global_batch(shards, tr["context"], tr["batch"], seed, s)
        ref_batches.append(want)
        for g, w in zip(lead["batches"][s], want):
            g = np.asarray(g)
            batch_diff += int((g != w).sum()) if g.shape == w.shape else int(w.size)
    dev = ctx.device

    def reference(precision):
        params, stats = ctx.reference_weights(dev)
        with exact_f32():
            return reference_steps(params, stats, ctx.config["widths"],
                                   ctx.config["static_knn"], ref_batches, tr["lr"], dev,
                                   block=tr["reference_block"], precision=precision)

    ref = reference("f32")
    if ctx.control:  # the reference in fp8 in the program's place
        prog = reference("fp8")
    else:
        names = leaf_map(lead["g1"], ref[1])
        prog = (lead["losses"], {names[n]: v for n, v in lead["g1"].items()},
                {names[n]: v for n, v in lead["change"].items()})
    g = gaps(*prog, *ref)
    print(f"benchmark: worst leaf grad {g['worst_grad']} change {g['worst_change']}; "
          f"median leaf grad {g['median_grad']!r} change {g['median_change']!r}",
          file=sys.stderr)
    return [("batch_diff", batch_diff, lim["batch_diff"]),
            ("loss_gap", g["loss_gap"], lim["loss_gap"]),
            ("grad_gap", g["grad_gap"], lim["grad_gap"]),
            ("change_gap", g["change_gap"], lim["change_gap"])]
