"""The skip rule and the visit order of kernel D's pruned arm (C <= 4),
settled on the CPU: the score bound of ops/knn_topk.py is sound for every
key of every group, and a model of the kernel's procedure (8-query warps,
32-key groups, own group first then outward, bounds tested per 32-group
chunk and again before each visit, strict skip) returns exactly
`knn_topk_plain`'s index lists.  No JAX: the plain version is held against
the Pallas kernel by tests/test_torch_knn_topk.py."""

import numpy as np
import pytest
import torch

from scp_tpu_torch.core.morton import morton_encode
from scp_tpu_torch.ops import knn as tknn
from scp_tpu_torch.ops import knn_topk as tk

N = 2048 + 37  # ragged: the last warp and the last group are partial
N_PAD = 60  # origin pad rows at the tail, as the codec pads a lane


def _sweep(rng, n):
    """A ring-structured LiDAR-like sweep (the bench cloud's generator)."""
    el = np.deg2rad(np.linspace(-24.8, 2.0, 64))[rng.integers(0, 64, n)]
    az = rng.uniform(0, 2 * np.pi, n)
    r = np.clip(rng.gamma(3.0, 8.0, n) + 2.0, 2.0, 120.0)
    return np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                     r * np.sin(el)], 1)


def cloud(seed, c, order="morton", dtype=torch.bfloat16, n=N, n_pad=N_PAD):
    """(1, n, c) positions as the codec gives the position graph: 16-bit
    quantized, scaled to [0, 1] in f32 and rounded to `dtype`, sorted by
    Morton code, with 200 duplicated points and a tail of n_pad origin pad
    rows.  At c = 4 the fourth column is the quantized range.  `order`:
    "morton", "shuffled" (the same rows permuted) or "identical" (one
    point)."""
    rng = np.random.default_rng(seed)
    pts = _sweep(rng, n - n_pad - 200)
    pts = np.concatenate([pts, pts[rng.integers(0, len(pts), 200)]])  # duplicates
    lo, hi = pts.min(0), pts.max(0)
    q = np.round((pts - lo) / (hi - lo) * 65535).astype(np.int64)
    q = q[np.argsort(morton_encode(q, 16), kind="stable")]
    if c == 4:
        rng_q = np.sqrt((q.astype(np.float64) ** 2).sum(1))
        q = np.concatenate([q, np.round(rng_q / rng_q.max() * 65535).astype(np.int64)[:, None]],
                           1)
    q = np.concatenate([q, np.zeros((n_pad, c), np.int64)])
    f = torch.from_numpy(q).float() * torch.tensor(np.float32(1.0 / 65535.0))
    if order == "shuffled":
        f = f[torch.from_numpy(rng.permutation(n))]
    elif order == "identical":
        f = f[:1].expand(n, c)
    return f.to(dtype)[None].contiguous()


def fma_scores(feats):
    """(1, N, C) -> (N, N) f32 scores as the kernel computes them: the dot
    as an fma chain over the columns, ((2 dot - |q|^2) - |k|^2) rounded at
    each step."""
    f = feats[0].float()
    dot = tk._fma_chain(f[:, None, 0], f[None, :, 0], None)
    for c in range(1, f.shape[1]):
        dot = tk._fma_chain(f[:, None, c], f[None, :, c], dot)
    sq = tk.fma_sqnorm(feats)[0]
    return (2.0 * dot - sq[:, None]) - sq[None, :]


def plain_scores(feats):
    """(1, N, C) -> (N, N) f32 scores exactly as knn_topk_plain computes
    them (the same 1024-row query tiles)."""
    sq = tk.fma_sqnorm(feats)
    return torch.cat([tknn._scores(feats[:, s0:s0 + 1024], sq[:, s0:s0 + 1024], feats, sq,
                                   round_bf16=False)[0]
                      for s0 in range(0, feats.shape[1], 1024)])


def group_max_scores(scores):
    """(N, N) -> (N, G): the best score of each 32-key group per query."""
    n = scores.shape[1]
    g = -(-n // tk.GROUP)
    s = torch.nn.functional.pad(scores, (0, g * tk.GROUP - n), value=float("-inf"))
    return s.reshape(n, g, tk.GROUP).amax(2)


def _bounds(feats):
    lo, hi, ksq = tk.group_boxes(feats)
    q = feats[0].float()[:, None, :]
    return tk.group_score_bound(q, lo[0][None], hi[0][None], ksq[0][None])  # (N, G)


def _hi32(x):
    """The high 32 bits of int64 order keys (floor division by 2^32)."""
    return x >> 32


def model_knn(feats, k, scores):
    """The kernel's procedure on one lane, all warps in lockstep: each warp
    (8 consecutive queries) walks its visit order in chunks of 32 groups;
    at a chunk's start a group is kept if any valid query's bound is not
    strictly below that query's current k-th score, and a kept group is
    tested again with the current thresholds just before it is scored.
    Scoring a group merges its keys into the 8 sorted lists (the kernel's
    one-by-one inserts give the same lists: the keys are unique).
    Returns the (N, k) lists and the count of groups each warp scored."""
    n = feats.shape[1]
    g_n, w_n = -(-n // tk.GROUP), -(-n // tk.QPW)
    key = tknn._ordered_key(scores)  # (N, N) int64, unique per column
    bound_key = _hi32(tknn._ordered_key(_bounds(feats)))  # the bounds' order keys
    qi = torch.arange(w_n * tk.QPW).reshape(w_n, tk.QPW)
    qvalid = qi < n
    qi = qi.clamp(max=n - 1)
    order = torch.from_numpy(np.stack([tk.visit_order(int(w * tk.QPW) // tk.GROUP, g_n)
                                       for w in range(w_n)]))  # (W, G)
    empty = torch.iinfo(torch.int64).min  # below every key
    lists = torch.full((w_n, tk.QPW, k), empty, dtype=torch.int64)
    visited = torch.zeros(w_n, dtype=torch.int64)
    warps = torch.arange(w_n)

    def keep(g):  # (W,) groups -> (W,) kept under the current thresholds
        b = bound_key[qi, g[:, None]]  # (W, 8)
        return (qvalid & (b >= _hi32(lists[:, :, k - 1]))).any(1)

    cols = torch.arange(tk.GROUP)
    for t in range(g_n):
        if t % tk.GROUP == 0:
            chunk = torch.stack([keep(order[:, u]) for u in range(t, min(t + tk.GROUP, g_n))], 1)
        g = order[:, t]
        w = warps[chunk[:, t % tk.GROUP] & keep(g)]
        if len(w) == 0:
            continue
        c = g[w, None] * tk.GROUP + cols  # (w, 32) key columns
        cand = key[qi[w][:, :, None], c.clamp(max=n - 1)[:, None, :]]  # (w, 8, 32)
        cand = torch.where((c < n)[:, None, :] & qvalid[w][:, :, None], cand, empty)
        lists[w] = torch.topk(torch.cat([lists[w], cand], 2), k, dim=2).values
        visited[w] += 1
    idx = (1 << 32) - 1 - (lists & 0xFFFFFFFF)
    return idx.reshape(w_n * tk.QPW, k)[:n], visited


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [3, 4])
def test_margin_bounds_every_key_of_every_group(c, dtype):
    """The kernel's fma-chain scores, and the plain version's, of every key
    stay at or below group_score_bound for every query and every group, on
    Morton-sorted quantized positions with duplicates and origin pad rows;
    the bound is not vacuous (most groups lie far below the best key)."""
    feats = cloud(c, c, dtype=dtype)
    bound = _bounds(feats)
    for scores in (fma_scores(feats), plain_scores(feats)):
        best = group_max_scores(scores)
        assert torch.all(best <= bound), float((best - bound).max())
    assert (bound < -1e-3).float().mean() > 0.5


@pytest.mark.parametrize("order", ["morton", "shuffled", "identical"])
@pytest.mark.parametrize("k", [1, 20, 32])
@pytest.mark.parametrize("c", [3, 4])
def test_model_of_the_pruned_search_gives_plain_lists(c, k, order):
    """The procedure with its skips returns knn_topk_plain's index lists,
    ties to the lowest column included; on one repeated point it prunes
    nothing."""
    feats = cloud(10 + c, c, order)
    got, visited = model_knn(feats, k, plain_scores(feats))
    want = tk.knn_topk_plain(feats, k)[0]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    if order == "identical":
        assert torch.equal(got, torch.arange(k).expand(N, k))
        assert int(visited.min()) == -(-N // tk.GROUP)


@pytest.mark.parametrize("k", [1, 20])
def test_skip_is_strict_on_exact_ties(monkeypatch, k):
    """On a coarse grid every score and every box gap is exact in f32, so
    with the margin taken away the bound of a group equals the score of
    its nearest key.  The procedure still returns the plain lists, with
    their lowest-column ties: a group whose bound equals a query's k-th
    score is scored, never skipped."""
    monkeypatch.setattr(tk, "MARGIN_REL", 0.0)
    monkeypatch.setattr(tk, "MARGIN_ABS", 0.0)
    rng = np.random.default_rng(7)
    q = rng.integers(0, 8, (N, 3))
    q = q[np.argsort(morton_encode(q, 3), kind="stable")]
    feats = (torch.from_numpy(q).float() / 8.0)[None]
    scores = plain_scores(feats)
    assert torch.all(group_max_scores(scores) <= _bounds(feats))
    got, visited = model_knn(feats, k, scores)
    torch.testing.assert_close(got, tk.knn_topk_plain(feats, k)[0], rtol=0, atol=0)
    assert float(visited.sum()) < len(visited) * -(-N // tk.GROUP)


@pytest.mark.parametrize("c", [3, 4])
def test_model_prunes_morton_sorted_positions(c):
    """On Morton-sorted positions the warps score under half of the
    brute-force (warp, group) pairs; shuffled rows leave nothing to prune
    (every group's box spans the cloud)."""
    shares = {}
    for order in ("morton", "shuffled"):
        feats = cloud(20 + c, c, order)
        _, visited = model_knn(feats, 20, plain_scores(feats))
        shares[order] = float(visited.sum()) / (len(visited) * -(-N // tk.GROUP))
    assert shares["morton"] < 0.5, shares
    assert shares["shuffled"] > 0.9, shares


@pytest.mark.parametrize("n_groups", [1, 2, 7, 66])
def test_visit_order_is_outward_and_complete(n_groups):
    """Every group once, the own group first, distances never falling, and
    at equal distance the group above first."""
    for g0 in range(n_groups):
        o = tk.visit_order(g0, n_groups)
        assert sorted(o.tolist()) == list(range(n_groups))
        assert o[0] == g0
        dist = np.abs(o - g0)
        assert np.all(np.diff(dist) >= 0)
        for i in range(1, n_groups - 1):
            if dist[i] == dist[i + 1]:
                assert o[i] > o[i + 1]


def test_group_boxes_leave_the_ragged_tail_out():
    """Rows >= N are not keys: the last, partial group's box and norm come
    from its real rows only."""
    feats = cloud(1, 3, "shuffled")
    lo, hi, ksq = tk.group_boxes(feats)
    last = feats[0, (N // tk.GROUP) * tk.GROUP:].float()
    assert lo.shape == (1, -(-N // tk.GROUP), 3)
    torch.testing.assert_close(lo[0, -1], last.amin(0), rtol=0, atol=0)
    torch.testing.assert_close(hi[0, -1], last.amax(0), rtol=0, atol=0)
    torch.testing.assert_close(ksq[0, -1], tk.fma_sqnorm(last[None])[0].amax(), rtol=0, atol=0)


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114knn_topk_boxesI13__nv_bfloat16Li3EEEvPKT_PfS5_iii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114knn_topk_boxesI13__nv_bfloat16Li3EEEvPKT_PfS5_iii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115knn_topk_prunedILi4EEEvPKfS2_iiiPlPy' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115knn_topk_prunedILi4EEEvPKfS2_iiiPlPy
    40 bytes stack frame, 40 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 80 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__5ce17e4e_11_knn_topk_cu_36a9a9f813knn_topk_wideI13__nv_bfloat16Li2EEEvPKT_PKfiiiiPl' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__5ce17e4e_11_knn_topk_cu_36a9a9f813knn_topk_wideI13__nv_bfloat16Li2EEEvPKT_PKfiiiiPl
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 182 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__5ce17e4e_11_knn_topk_cu_36a9a9f813knn_topk_wideIfLi1EEEvPKT_PKfiiiiPl' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__5ce17e4e_11_knn_topk_cu_36a9a9f813knn_topk_wideIfLi1EEEvPKT_PKfiiiiPl
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
"""


def test_chip_smoke_fails_on_a_spilling_pruned_knn_kernel(tmp_path, monkeypatch):
    """chip_smoke.py's phase 1 reads kernel D's kernels from the build log
    (the pruned arm's search by row width, its pre-pass by type and C, the
    wide arm by type and list slots per lane), fails on a spill, and fails
    when the wide arm is missing."""
    import chip_smoke
    from scp_tpu_torch.ops import _cuda

    log = tmp_path / "k.log"
    log.write_text(PTXAS_LOG)
    monkeypatch.setattr(_cuda, "log_path", lambda src: str(log))
    with pytest.raises(AssertionError, match=r"knn_topk_pruned<4> spills"):
        chip_smoke.knn_resources(_cuda)
    log.write_text(PTXAS_LOG.replace("40 bytes spill stores, 20", "0 bytes spill stores, 0"))
    rows = chip_smoke.knn_resources(_cuda)
    assert set(rows) == {"knn_topk_pruned<4>", "knn_topk_boxes<bf16,3>",
                         "knn_topk_wide<bf16,2>", "knn_topk_wide<f32,1>"}
    assert rows["knn_topk_pruned<4>"]["registers"] == 80
    assert rows["knn_topk_wide<bf16,2>"]["registers"] == 182
    assert rows["knn_topk_wide<bf16,2>"]["stack"] == 0
    log.write_text(PTXAS_LOG.split("ptxas info    : Compiling entry function '_ZN44")[0])
    with pytest.raises(AssertionError, match="no knn_topk_wide"):
        chip_smoke.knn_resources(_cuda)


def test_cpu_tensor_runs_the_plain_version_and_counts_nothing():
    """A CPU tensor takes the plain version: no launch is counted and the
    visited-groups counter is left as it was."""
    feats = cloud(2, 3)
    stats = torch.zeros(1, dtype=torch.int64)
    n0 = tk.knn_topk.launches
    got = tk.knn_topk(feats, 20, stats=stats)
    torch.testing.assert_close(got, tk.knn_topk_plain(feats, 20), rtol=0, atol=0)
    assert tk.knn_topk.launches == n0 and int(stats) == 0
