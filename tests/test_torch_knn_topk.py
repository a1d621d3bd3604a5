"""Kernel D's plain version (scp_tpu_torch/ops/knn_topk.py) against the
Pallas kernel it replaces, scp_tpu/ops/pallas_knn.py::knn_pallas in
interpret mode (as tests/test_ops.py runs it), and the port's dispatch
rule.  The CUDA kernel itself is held against the plain version in
tests/test_torch_kernels.py, on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scp_tpu.ops.pallas_knn import knn_pallas
from scp_tpu_torch.ops import knn as tknn
from scp_tpu_torch.ops import knn_topk as tknn_topk


@pytest.mark.parametrize("c,k", [pytest.param(3, 20, id="3"), pytest.param(16, 20, id="16"),
                                 pytest.param(144, 20, id="144"), (16, 64)])
def test_plain_matches_pallas_index_exact(c, k):
    """Random f32 features have no tied scores: both sides score in f32,
    so the index lists agree exactly.  N = 1500 is ragged and spans two of
    the Pallas kernel's 1024-key tiles; k = 64 fills the Pallas kernel's
    128-lane buffer (2k) and takes two list slots per lane in kernel D."""
    rng = np.random.default_rng(c)
    feats = rng.normal(size=(1, 1500, c)).astype(np.float32)
    want = np.asarray(knn_pallas(jnp.asarray(feats), k, interpret=True))
    got = tknn_topk.knn_topk_plain(torch.from_numpy(feats), k)
    assert got.dtype == torch.int64 and got.shape == (1, 1500, k)
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_matches_pallas_at_c300_up_to_f32_rounding():
    """C = 300 (rows padded to 16 bytes in kernel D): the lists agree on
    every row but where two picks' exact distances differ by less than the f32
    error bound of their scores (each a 300-term sum in another order on
    each side, 2 C 2^-24 (|q| + |k|)^2); there the two may swap.  With
    this input one row of 1500 swaps two neighbors whose exact distances
    differ by 2.9e-5 (6e-8 relative)."""
    c, k = 300, 20
    rng = np.random.default_rng(c)
    feats = rng.normal(size=(1, 1500, c)).astype(np.float32)
    want = np.asarray(knn_pallas(jnp.asarray(feats), k, interpret=True))[0]
    got = tknn_topk.knn_topk_plain(torch.from_numpy(feats), k).numpy()[0]
    f = feats[0].astype(np.float64)
    norm = np.sqrt((f * f).sum(-1))
    rows = np.nonzero((got != want).any(-1))[0]
    assert len(rows) <= 1e-3 * len(got)
    for i in rows:
        for a, b in zip(got[i], want[i]):
            if a != b:
                gap = abs(((f[a] - f[i]) ** 2).sum() - ((f[b] - f[i]) ** 2).sum())
                bound = 2 * c * 2.0 ** -24 * (norm[i] + max(norm[a], norm[b])) ** 2
                assert gap <= bound, (i, a, b, gap, bound)


def test_duplicate_points_distance_multisets_and_lowest_index_first():
    """Positions on a coarse grid repeat and tie exactly (every score is
    exact in f32 there).  The neighbor distances agree with the Pallas
    kernel's as multisets, and the port's order is (distance, index): among
    exact duplicates the lowest index comes first."""
    rng = np.random.default_rng(5)
    n, k = 1100, 20
    feats = (rng.integers(0, 8, (1, n, 3)) / 8.0).astype(np.float32)
    got = tknn_topk.knn_topk_plain(torch.from_numpy(feats), k).numpy()
    want = np.asarray(knn_pallas(jnp.asarray(feats), k, interpret=True))
    f = feats[0].astype(np.float64)
    d = ((f[:, None, :] - f[None, :, :]) ** 2).sum(-1)  # (n, n) exact

    def dists(idx):
        return np.sort(np.take_along_axis(d, idx[0].astype(np.int64), 1), axis=1)

    np.testing.assert_array_equal(dists(got), dists(want))
    cols = np.arange(n)
    for i in range(0, n, 7):
        order = np.lexsort((cols, d[i]))[:k]  # by distance, then index
        np.testing.assert_array_equal(got[0, i], order)
    assert (d[cols[:, None], got[0]] == 0).sum() > n  # duplicates are present


def test_fused_dispatch_threshold_and_cpu_plain():
    """knn_indices(fused=True) takes graphs of N >= 2048 rows to kernel D's
    op (f32 scores; on a CPU tensor its plain version, no launch counted)
    and leaves smaller graphs on the chunked path, whose bf16 features
    keep bf16 scores."""
    rng = np.random.default_rng(0)
    before = tknn_topk.knn_topk.launches
    big = torch.from_numpy(rng.random((1, 2048, 3)).astype(np.float32)).bfloat16()
    torch.testing.assert_close(tknn.knn_indices(big, 20, fused=True),
                               tknn_topk.knn_topk_plain(big, 20), rtol=0, atol=0)
    small = big[:, :2047].contiguous()
    torch.testing.assert_close(tknn.knn_indices(small, 20, fused=True),
                               tknn.knn_indices(small, 20), rtol=0, atol=0)
    assert tknn.FUSED_MIN_N == 2048
    assert tknn_topk.knn_topk.launches == before
    # f32 scores separate neighbors that bf16 scores tie
    assert not torch.equal(tknn_topk.knn_topk_plain(big, 20), tknn.knn_indices(big, 20))


def test_plain_matches_pallas_index_exact_on_quantized_positions():
    """The position graph the codec builds: normalized u16-quantized
    positions of the bench-like cloud tie exactly in many distances.  The
    norms' fused multiply-add chain rounds those ties as the compiled
    Pallas kernel does, so the index lists agree exactly."""
    from scp_tpu_torch.codec.slices import split_levels
    from scp_tpu_torch.core.preprocess import kitti_qs, preprocess_points

    rng = np.random.default_rng(0)
    el = np.deg2rad(np.linspace(-24.8, 2.0, 64))[rng.integers(0, 64, 4000)]
    az = rng.uniform(0, 2 * np.pi, 4000)
    r = np.clip(rng.gamma(3.0, 8.0, 4000) + 2.0, 2.0, 120.0)
    pts = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                    r * np.sin(el)], 1)
    sl = split_levels(preprocess_points(pts, system="spher", qs=kitti_qs(12)).context,
                      angular=True)
    pos = sl.level_pos(int(np.argmax(sl.level_sizes)))[:2048][None]
    want = np.asarray(knn_pallas(jnp.asarray(pos), 20, interpret=True))
    got = tknn_topk.knn_topk_plain(torch.from_numpy(pos), 20).numpy()
    np.testing.assert_array_equal(got, want)
    # each product rounded (scp_tpu's XLA norm) breaks some of those ties
    # the other way
    f = torch.from_numpy(pos)
    rounded = tknn.chunked_knn(f, 20, torch.sum(f * f, -1), round_bf16=False).numpy()
    assert (rounded != want).any()

