"""`correct` for the OctAttention sweeps traffic: the program's outputs
against the plain reference (reference/octree.py, reference/octattention.py),
after the window.

Numbers compared (limits in limits/<cell>.json):
  octree_diff   rows of the program's (N, 4, 6) octree contexts that differ
                from the reference octree's, plus level sizes that differ
                (exact, 0);
  decode_diff   decoded symbols of every sweep of the window that differ
                from the reference octree's (exact, 0);
  context_diff  nodes of one level, drawn from the seed, whose model inputs
                at the decoder's step (ancestor rows, the node's level and
                octant, positions) differ from the reference's window rows;
                the step's own occupancy is the unknown symbol and is not
                compared (exact, 0);
  p_gap_bits    over every node of the sweep: the mean of |log2
                p_program(y) - log2 p_reference(y)| at the true symbol y,
                the program's logits those of its decoder's steps, the
                reference's full forward over 1024-row windows in float32
                with TF32 off.
"""

from __future__ import annotations

import numpy as np

from benchmark.checks.sweeps import GapSums
from benchmark.reference import octattention as ref_oct
from benchmark.reference.octree import Octree, kitti_qs, spherical_grid

REF_WINDOWS = 32  # reference windows per block


def octree_diff(rows: np.ndarray, tree: Octree, sizes) -> int:
    want = tree.shard()
    diff = sum(a != b for a, b in zip(sizes, tree.sizes)) + abs(len(sizes) - len(tree.sizes))
    if rows.shape != want.shape:
        return diff + abs(rows.shape[0] - want.shape[0]) + 1
    return diff + int((rows != want).any(axis=(1, 2)).sum())


def context_diff(cap, tree: Octree, csz: int) -> int:
    """Nodes of the kept level whose step inputs differ from the reference's."""
    data, pos, _ = ref_oct.level_rows(tree, cap.keep_level)
    n = data.shape[0]
    positions = min(csz, n)
    diff = abs(len(cap.inputs) - positions) * -(-n // csz)
    for j, (d_j, p_j) in enumerate(cap.inputs[:positions]):
        d_j, p_j = d_j.cpu().numpy(), p_j.cpu().numpy()
        lanes = np.arange(-(-(n - j) // csz))
        want_d, want_p = data[lanes * csz + j], pos[lanes * csz + j]
        got_d, got_p = d_j[lanes].copy(), p_j[lanes]
        got_d[:, -1, 0] = want_d[:, -1, 0]  # the step's own occupancy is unknown
        diff += int(((got_d != want_d).reshape(len(lanes), -1).any(1)
                     | (got_p != want_p).reshape(len(lanes), -1).any(1)).sum())
    return diff


def reference_windows(model, tree, csz, device, control=None, block=REF_WINDOWS):
    """Yield (level index, chunk, real rows m, logits (m, 255), symbols (m,),
    the control's logits or None) of every window, in blocks of windows."""
    import torch

    wins = list(ref_oct.sweep_windows(tree, csz))
    for i in range(0, len(wins), block):
        part = wins[i:i + block]
        d = torch.from_numpy(np.stack([w[3] for w in part])).to(device)
        p = torch.from_numpy(np.stack([w[4] for w in part])).to(device)
        with torch.no_grad():
            logits = model.forward(d, p)
            ctrl = control.forward(d, p) if control is not None else None
        for b, (li, c, m, _, _, y) in enumerate(part):
            yield (li, c, m, logits[b, :m], torch.from_numpy(y[:m]).to(device),
                   None if ctrl is None else ctrl[b, :m])
        del logits, ctrl


def compare(ctx, sweep, state, cap, params) -> list:
    import torch

    lim = ctx.limits()
    dev = ctx.device
    widths = ctx.config["widths"]
    csz = widths["context_size"]
    tree = Octree(spherical_grid(sweep, kitti_qs(ctx.traffic["lidar_level"])))
    ref_sym = tree.symbols()
    decode = 0
    for codes in state["codes"]:
        decode += (int((codes != ref_sym).sum()) if codes.shape == ref_sym.shape
                   else max(len(codes), len(ref_sym)))
    checks = [("octree_diff", octree_diff(state["rows"], tree, state["sizes"]),
               lim["octree_diff"]),
              ("decode_diff", decode, lim["decode_diff"]),
              ("context_diff", context_diff(cap, tree, csz), lim["context_diff"])]
    with ref_oct.exact_f32():
        model = ref_oct.Reference(params, widths)
        control = ref_oct.Reference(params, widths, precision="bf16") if ctx.control else None
        gaps = GapSums()
        levels, stacked = len(cap.logits), {}
        missing = len(tree.sizes) != levels
        for li, c, m, logits, y, ctrl in reference_windows(model, tree, csz, dev, control):
            if li >= levels:
                missing = True
                break
            if li not in stacked:
                stacked.clear()
                stacked[li] = torch.stack(cap.logits[li])
            prog = stacked[li]
            if prog.shape[0] < m or prog.shape[1] <= c:
                missing = True
                continue
            gaps.add(0, ctrl if ctrl is not None else prog[:m, c].float(), logits, y)
        gap = None if missing else gaps.means()[0]
    return checks + [("p_gap_bits", gap, lim["p_gap_bits"])]
