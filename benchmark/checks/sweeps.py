"""`correct` for the sweeps traffic: the program's outputs against the
plain reference (reference/octree.py, reference/ehem.py), after the window.

Numbers compared (limits in limits/<cell>.json):
  octree_diff   symbols and level sizes of the program's octree of every
                distinct sweep that differ from the reference's (exact, 0);
  decode_diff   decoded symbols of every sweep of the window that differ
                from the reference's octree (exact, 0);
  context_diff  rows of the sampled sweep's model inputs (ancestor rows,
                quantized positions, group-1 symbols fed to phase 2) that
                differ from the reference's contexts (exact, 0);
  p1_gap_bits,  over the sampled sweep's real nodes of group 1 (phase 1)
  p2_gap_bits   and group 2 (phase 2): the mean of |log2 p_program(y) -
                log2 p_reference(y)| at the true symbol y, the reference in
                float32 with TF32 off.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.reference import ehem as ref_ehem
from benchmark.reference.octree import Octree, SweepContexts, spherical_grid

REF_BATCH_ROWS = 4 * 8192  # reference rows per block of windows


def lanes_of(calls):
    """The captured phase calls split into lanes, in coding order:
    [(data (w, 4, 3), pos (w, 3), logits1 (w/2, 255), occ1 (w/2,), logits2)]."""
    lanes, pend = [], None
    for c in calls:
        if c[0] == "p1":
            pend = c
            continue
        _, d, p, l1 = pend
        _, occ, l2 = c
        for i in range(d.shape[0]):
            lanes.append((d[i], p[i], l1[i], occ[i], l2[i]))
        pend = None
    return lanes


class GapSums:
    """Running sums of |log2 p_a(y) - log2 p_b(y)| by group."""

    def __init__(self):
        self.sum = [0.0, 0.0]
        self.n = [0, 0]

    def add(self, group, logits_a, logits_b, y):
        import torch

        real = y != 255
        if not bool(real.any()):
            return
        ya = y[real].long()[:, None]
        la = torch.log_softmax(logits_a[real].double(), -1).gather(1, ya)
        lb = torch.log_softmax(logits_b[real].double(), -1).gather(1, ya)
        self.sum[group] += float((la - lb).abs().sum()) / math.log(2.0)
        self.n[group] += int(real.sum())

    def means(self):
        return [s / n if n else None for s, n in zip(self.sum, self.n)]


def reference_windows(model, ctxs, device, batch_rows=REF_BATCH_ROWS, control=None):
    """Yield (window index, logits1, logits2, y (w,), data, pos, control's
    (logits1, logits2) or None) of the reference `model` over every
    modelled window of `ctxs`, in blocks of windows of one width."""
    import torch

    wins = list(ctxs.windows())
    i = 0
    while i < len(wins):
        w = wins[i][3].shape[0]
        j = i
        while j < len(wins) and wins[j][3].shape[0] == w and (j - i + 1) * w <= batch_rows:
            j += 1
        j = max(j, i + 1)
        d = torch.from_numpy(np.stack([x[3] for x in wins[i:j]])).to(device)
        p = torch.from_numpy(np.stack([x[4] for x in wins[i:j]])).to(device)
        y = torch.from_numpy(np.stack([x[5] for x in wins[i:j]]).astype(np.int64)).to(device)
        with torch.no_grad():
            l1, f1, f2 = model.phase1(d, p)
            l2 = model.phase2(f1, f2, y[:, 0::2])
            del f1, f2
            if control is not None:
                c1, cf1, cf2 = control.phase1(d, p)
                c2 = control.phase2(cf1, cf2, y[:, 0::2])
                del cf1, cf2
        for b in range(j - i):
            yield (i + b, l1[b], l2[b], y[b], d[b], p[b],
                   None if control is None else (c1[b], c2[b]))
        del l1, l2
        i = j


def compare(ctx, cycle, qs, state, calls, sample) -> list:
    cfg = ctx.config
    lim = ctx.limits()
    dev = ctx.device
    trees = {m: Octree(spherical_grid(cycle[m], qs)) for m in sorted(state["member_sizes"])}

    octree_diff = 0
    for m, sl in state["slices"].items():
        t = trees[m]
        ref_sym = t.symbols()
        if sl.occ_stream.shape != ref_sym.shape:
            octree_diff += abs(len(sl.occ_stream) - len(ref_sym)) + 1
        else:
            octree_diff += int((sl.occ_stream != ref_sym).sum())
        octree_diff += sum(a != b for a, b in zip(sl.level_sizes, t.sizes)) \
            + abs(len(sl.level_sizes) - len(t.sizes))
    decode_diff = 0
    for m, codes in state["codes"]:
        ref_sym = trees[m].symbols()
        decode_diff += (int((codes != ref_sym).sum()) if codes.shape == ref_sym.shape
                        else max(len(codes), len(ref_sym)))

    with ref_ehem.exact_f32():
        params, stats = ctx.reference_weights(dev)
        model = ref_ehem.Reference(params, stats, cfg["widths"], cfg["static_knn"])
        control = (ref_ehem.Reference(params, stats, cfg["widths"], cfg["static_knn"],
                                      precision="fp8") if ctx.control else None)
        ctxs = SweepContexts(trees[sample], cfg["context_size"])
        lanes = lanes_of(calls)
        n_ref = sum(1 for _ in ctxs.windows())
        context_diff = abs(len(lanes) - n_ref)
        gaps = GapSums()
        for i, l1, l2, y, d, p, ctrl in reference_windows(model, ctxs, dev, control=control):
            if i >= len(lanes):
                break
            pd, pp, pl1, pocc, pl2 = (x.to(dev) for x in lanes[i])
            if pd.shape != d.shape:
                context_diff += d.shape[0]
                continue
            context_diff += int(((pd != d).flatten(1).any(1) | (pp != p).any(1)).sum())
            context_diff += int((pocc.long() != y[0::2]).sum())
            if ctrl is not None:
                pl1, pl2 = ctrl
            gaps.add(0, pl1.float(), l1, y[0::2])
            gaps.add(1, pl2.float(), l2, y[1::2])
        p1, p2 = gaps.means()
    return [("octree_diff", octree_diff, lim["octree_diff"]),
            ("decode_diff", decode_diff, lim["decode_diff"]),
            ("context_diff", context_diff, lim["context_diff"]),
            ("p1_gap_bits", p1, lim["p1_gap_bits"]),
            ("p2_gap_bits", p2, lim["p2_gap_bits"])]

