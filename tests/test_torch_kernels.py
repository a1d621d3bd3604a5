"""The port's CUDA kernels against their plain PyTorch versions, on the
card (marker `cuda`; they skip without one: a CUDA kernel has no CPU
mode).  This file imports no JAX, so it also runs on a machine that has
none (conftest.py imports JAX, so leave it out):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from scp_tpu_torch.ops import knn_topk as tknn
from scp_tpu_torch.ops import mlp as tmlp
from scp_tpu_torch.ops import swin_attn as tswin
from scp_tpu_torch.ops import window_attn as twattn

TOL = 3e-2  # bf16 outputs: kernel and plain version round at the same points


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_a_matches_plain_on_card(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    m, c, f = 1000, 256, 1024  # ragged token count: the last row tile is partial

    def r(*s, scale=1.0):
        return torch.randn(*s, generator=g, device=cuda_device) * scale

    args = (r(m, c).bfloat16(), 1 + r(c, scale=0.1), r(c, scale=0.1),
            r(f, c, scale=0.05).bfloat16(), r(f, scale=0.05),
            r(c, f, scale=0.05).bfloat16(), r(c, scale=0.05), 1e-5)
    for act in ("gelu", "leaky"):
        n0 = tmlp.ln_mlp_residual.launches
        got = tmlp.ln_mlp_residual(*args, act)
        assert tmlp.ln_mlp_residual.launches == n0 + 1
        torch.testing.assert_close(got.float(), tmlp.ln_mlp_residual_plain(*args, act).float(),
                                   atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n_masks", [1, 4])
def test_kernels_b_c_match_plain_on_card(cuda_device, n_masks):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    bn, w, c, h = 4, 512, 256, 4

    def r(*s, scale=1.0):
        return torch.randn(*s, generator=g, device=cuda_device) * scale

    mask = torch.where(torch.rand(n_masks, w, w, generator=g, device=cuda_device) < 0.1,
                       -100.0, 0.0)
    x, qs = r(bn, w, c).bfloat16(), r(bn, w, c).bfloat16()
    ln = (1 + r(c, scale=0.1), r(c, scale=0.1))
    rel = r(h, w, w, scale=0.2)
    wp, bp = r(c, c, scale=0.05).bfloat16(), r(c, scale=0.05)
    self_args = (x, *ln, r(3 * c, c, scale=0.05).bfloat16(), r(3 * c, scale=0.05), rel,
                 mask, wp, bp, h, 1e-5)
    torch.testing.assert_close(tswin.attn_sublayer_self(*self_args).float(),
                               tswin.attn_sublayer_self_plain(*self_args).float(),
                               atol=TOL, rtol=TOL)
    cross_args = (x, qs, *ln, r(c, c, scale=0.05).bfloat16(), r(c, scale=0.05),
                  r(2 * c, c, scale=0.05).bfloat16(), r(2 * c, scale=0.05), rel, mask,
                  wp, bp, h, 1e-5)
    torch.testing.assert_close(tswin.attn_sublayer_cross(*cross_args).float(),
                               tswin.attn_sublayer_cross_plain(*cross_args).float(),
                               atol=TOL, rtol=TOL)


def _same_neighbors(got, want, feats, min_rows=0.999, rtol=1e-5):
    """Index lists identical on >= min_rows of the rows; on every row the
    sorted exact (f64) distances of both picks agree within rtol."""
    assert got.shape == want.shape and got.dtype == torch.int64
    same = (got == want).all(-1).float().mean().item()
    assert same >= min_rows, same
    f = feats.double()

    def dists(idx):
        nb = torch.gather(f[:, None].expand(-1, idx.shape[1], -1, -1), 2,
                          idx[..., None].expand(-1, -1, -1, f.shape[-1]))
        return ((nb - f[:, :, None]) ** 2).sum(-1).sort(-1).values

    dg, dw = dists(got), dists(want)
    assert torch.all((dg - dw).abs() <= rtol * dw.abs() + 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 144, 192])
def test_kernel_d_matches_plain_on_card(cuda_device, c):
    g = torch.Generator(device=cuda_device).manual_seed(c)
    n = 2048 + 37  # ragged: the last query and key tiles are partial
    feats = torch.randn(2, n, c, generator=g, device=cuda_device).bfloat16()
    n0 = tknn.knn_topk.launches
    got = tknn.knn_topk(feats, 20)
    assert tknn.knn_topk.launches == n0 + 1
    _same_neighbors(got, tknn.knn_topk_plain(feats, 20), feats)
    assert torch.equal(got, tknn.knn_topk(feats, 20))  # launches are deterministic
    f32 = feats.float()
    _same_neighbors(tknn.knn_topk(f32, 20), tknn.knn_topk_plain(f32, 20), f32)


@pytest.mark.cuda
def test_kernel_d_duplicate_points_take_the_lowest_index(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(9)
    n = 2048 + 37
    # a coarse grid: every score is exact in f32 and duplicates abound
    feats = (torch.randint(0, 8, (1, n, 3), generator=g, device=cuda_device) / 8.0).bfloat16()
    got = tknn.knn_topk(feats, 20)
    assert torch.equal(got, tknn.knn_topk_plain(feats, 20))
    f = feats[0].double().cpu().numpy()
    d = ((f[:, None] - f[None]) ** 2).sum(-1)
    cols = np.arange(n)
    for i in range(0, n, 97):
        assert got[0, i].tolist() == np.lexsort((cols, d[i]))[:20].tolist()


@pytest.mark.cuda
def test_kernel_d_refuses_what_it_does_not_take(cuda_device):
    feats = torch.randn(1, 2048, 3, device=cuda_device)
    with pytest.raises(ValueError):
        tknn.knn_topk(feats, 65)
    with pytest.raises(ValueError):
        tknn.knn_topk(feats[:, :40].contiguous(), 41)
    with pytest.raises(ValueError):
        tknn.knn_topk(feats.half(), 20)


@pytest.mark.cuda
@pytest.mark.parametrize("c,k,dtype", [
    (144, 20, torch.bfloat16), (192, 20, torch.bfloat16), (144, 64, torch.bfloat16),
    (192, 64, torch.bfloat16), (300, 20, torch.bfloat16), (192, 20, torch.float32),
    (300, 64, torch.float32), (3, 40, torch.bfloat16), (1700, 20, torch.bfloat16)])
def test_kernel_d_wide_arm_on_card(cuda_device, c, k, dtype):
    """The wide arm at the Pallas kernel's reach: the dynamic graph's C =
    144 / 192 at k = 20 and 64, C = 300 (rows padded to 16 bytes), f32
    (the fma-chain filter), positions at k = 40 (past the pruned arm's
    32) and C = 1700 (queries streamed beside the keys, not resident);
    ragged N, deterministic.  Its scores take the exact dot rounded once,
    as the plain version's do: bf16 lists equal the plain lists; f32 dots
    round in f64 first, in another order on each side."""
    g = torch.Generator(device=cuda_device).manual_seed(c + k)
    n = 2048 + 37
    feats = torch.randn(2, n, c, generator=g, device=cuda_device).to(dtype)
    assert not tknn.takes_pruned_arm(c, k)
    n0, w0 = tknn.knn_topk.launches, tknn.knn_topk.arms["wide"]
    got = tknn.knn_topk(feats, k)
    assert tknn.knn_topk.launches == n0 + 1 and tknn.knn_topk.arms["wide"] == w0 + 1
    want = tknn.knn_topk_plain(feats, k)
    if dtype == torch.bfloat16:
        assert torch.equal(got, want)
    _same_neighbors(got, want, feats)
    assert torch.equal(got, tknn.knn_topk(feats, k))


def _pruned_case(feats, k):
    """Kernel D's pruned arm (C <= 4) on the card: index lists identical to
    the plain version's, two launches identical, and the visited-groups
    counter inside (0, brute force].  Returns the indices and the share of
    (warp, group) pairs scored."""
    b, n, _ = feats.shape
    stats = torch.zeros(1, dtype=torch.int64, device=feats.device)
    n0 = tknn.knn_topk.launches
    got = tknn.knn_topk(feats, k, stats=stats)
    assert tknn.knn_topk.launches == n0 + 1
    assert torch.equal(got, tknn.knn_topk_plain(feats, k))
    assert torch.equal(got, tknn.knn_topk(feats, k))
    total = b * -(-n // tknn.QPW) * -(-n // tknn.GROUP)
    assert 0 < int(stats) <= total
    return got, int(stats) / total


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("order", ["morton", "shuffled"])
def test_kernel_d_pruned_arm_identical_on_positions(cuda_device, dtype, order):
    """Morton-sorted quantized positions (duplicates, origin pad rows) at
    (2, 8192 + 37, 3), and the same rows shuffled: identical lists; the
    sorted lanes take under half of the brute-force work."""
    from test_torch_knn_prune import cloud

    n = 8192 + 37
    feats = torch.cat([cloud(s, 3, order, dtype, n=n) for s in (0, 1)]).to(cuda_device)
    _, share = _pruned_case(feats, 20)
    assert share < 0.5 if order == "morton" else share > 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_point", "pad_tail", "k1", "k32", "c4", "n2048"])
def test_kernel_d_pruned_arm_edge_cases(cuda_device, case):
    """A lane of one repeated point (the lowest columns win every tie); a
    lane whose last 1500 rows are origin pad rows; k = 1 and k = 32; C = 4;
    N = 2048, the fused path's smallest graph."""
    from test_torch_knn_prune import cloud

    n, c, k, order, n_pad = 8192 + 37, 3, 20, "morton", 60
    if case == "one_point":
        n, order = 2048 + 37, "identical"
    elif case == "pad_tail":
        n, n_pad = 4096, 1500
    elif case in ("k1", "k32"):
        k = int(case[1:])
    elif case == "c4":
        c = 4
    elif case == "n2048":
        n = 2048
    feats = cloud(5, c, order, n=n, n_pad=n_pad).to(cuda_device)
    got, _ = _pruned_case(feats, k)
    if case == "one_point":
        assert torch.equal(got[0].cpu(), torch.arange(k).expand(n, k))


@pytest.mark.cuda
def test_kernel_d_stats_counter_rules(cuda_device):
    """The wide arm (C > 4) leaves the counter as it is; a counter of the
    wrong type or size is refused."""
    feats = torch.randn(1, 2048, 8, device=cuda_device)
    stats = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    tknn.knn_topk(feats, 20, stats=stats)
    assert int(stats) == 0
    with pytest.raises(ValueError):
        tknn.knn_topk(feats, 20, stats=stats.int())
    with pytest.raises(ValueError):
        tknn.knn_topk(feats, 20, stats=torch.zeros(2, dtype=torch.int64, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("n_masks", [1, 4])
def test_kernel_e_matches_plain_on_card(cuda_device, hd, n_masks):
    g = torch.Generator(device=cuda_device).manual_seed(hd + n_masks)
    bn, h, w = 6, 4, 512  # 6 windows over 4 masks: window n uses mask n % 4

    def r(*s, scale=1.0):
        return torch.randn(*s, generator=g, device=cuda_device) * scale

    q, k, v = (r(bn, h, w, hd).bfloat16() for _ in range(3))
    bias = r(h, w, w, scale=0.5)
    mask = torch.where(torch.rand(n_masks, w, w, generator=g, device=cuda_device) < 0.2,
                       -100.0, 0.0)
    n0 = twattn.window_attention.launches
    got = twattn.window_attention(q, k, v, bias, mask, hd ** -0.5)
    assert twattn.window_attention.launches == n0 + 1
    torch.testing.assert_close(got.float(),
                               twattn.window_attention_plain(q, k, v, bias, mask,
                                                             hd ** -0.5).float(),
                               atol=TOL, rtol=TOL)


@pytest.mark.cuda
def test_kernel_e_refuses_what_it_does_not_take(cuda_device):
    def qkv(w, hd):
        return torch.randn(2, 4, w, hd, device=cuda_device).bfloat16()

    bias, mask = torch.zeros(4, 192, 192, device=cuda_device), torch.zeros(1, 192, 192,
                                                                           device=cuda_device)
    with pytest.raises(ValueError):  # W not a multiple of 128
        twattn.window_attention(qkv(192, 64), qkv(192, 64), qkv(192, 64), bias, mask, 0.125)
    q = qkv(128, 64)
    with pytest.raises(ValueError):  # a bias left on the CPU
        twattn.window_attention(q, q, q, torch.zeros(4, 128, 128), mask[:, :128, :128], 0.125)
    q264 = qkv(128, 264)
    with pytest.raises(ValueError):  # head dim above the core's 256
        twattn.window_attention(q264, q264, q264, bias[:, :128, :128], mask[:, :128, :128],
                                0.0625)
    assert not twattn.supported(128, 264) and not twattn.supported(1024, 64)
    with pytest.raises(ValueError):  # f16 is neither of the kernel's types
        twattn.window_attention(q.half(), q.half(), q.half(), bias[:, :128, :128], None, 0.125)


# ---- the attention core of B, C and E, in bf16 and f32 ----------------------

F32_TOL = 1e-4  # f32 on the CUDA cores, no TF32: summation order only


def _tol(dtype):
    return TOL if dtype == torch.bfloat16 else F32_TOL


def _core_inputs(dev, seed, bn, h, w, hd, n_masks, dtype, layout):
    """q, k, v as (BN, H, W, hd) views: head-major tensors, or the
    column-strided (BN*W, 3*H*hd) projection buffer B's GEMM writes."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if layout == "heads":
        q, k, v = (torch.randn(bn, h, w, hd, generator=g, device=dev).to(dtype)
                   for _ in range(3))
    else:
        c = h * hd
        qkv = torch.randn(bn * w, 3 * c, generator=g, device=dev).to(dtype)
        q, k, v = (qkv[:, i * c:(i + 1) * c].reshape(bn, w, h, hd).permute(0, 2, 1, 3)
                   for i in range(3))
    bias = torch.randn(h, w, w, generator=g, device=dev) * 0.5
    mask = None if n_masks == 0 else torch.where(
        torch.rand(n_masks, w, w, generator=g, device=dev) < 0.2, -100.0, 0.0)
    return q, k, v, bias, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [16, 32, 48, 64, 128])
@pytest.mark.parametrize("layout", ["heads", "columns"])
def test_attention_core_matches_plain_on_card(cuda_device, dtype, hd, layout):
    bn, h, w = 5, 2, 512  # 5 windows over 2 masks: window n uses mask n % 2
    q, k, v, bias, mask = _core_inputs(cuda_device, hd, bn, h, w, hd, 2, dtype, layout)
    n0 = twattn.window_attention.launches
    got = twattn.window_attention(q, k, v, bias, mask, hd ** -0.5)
    assert twattn.window_attention.launches == n0 + 1
    assert got.dtype == dtype and got.shape == (bn, h, w, hd)
    want = twattn.window_attention_plain(q, k, v, bias, mask, hd ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n_masks,bn,w", [(0, 3, 128), (1, 7, 256), (2, 9, 512),
                                          (16, 37, 512), (16, 5, 384)])
def test_attention_core_masks_and_ragged_windows_on_card(cuda_device, dtype, n_masks, bn, w):
    """No mask, 1, 2 and 16 masks; window counts that are no multiple of
    the mask count or of the query-tile split."""
    hd = 64
    q, k, v, bias, mask = _core_inputs(cuda_device, 100 + n_masks, bn, 4, w, hd, n_masks,
                                       dtype, "columns")
    got = twattn.window_attention(q, k, v, bias, mask, hd ** -0.5)
    want = twattn.window_attention_plain(q, k, v, bias, mask, hd ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.cuda
def test_attention_core_at_head_dims_past_64_and_windows_of_64(cuda_device):
    """Head dims that stream K and V in 64-column chunks (72, 200, 256),
    and the 64-row window B and C admit, through the core's launcher."""
    for hd, w in ((72, 128), (200, 128), (256, 512), (24, 64)):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, bias, mask = _core_inputs(cuda_device, hd, 3, 2, w, hd, 1, dtype, "heads")
            out = torch.empty((3, w, 2, hd), dtype=dtype, device=cuda_device).permute(0, 2, 1, 3)
            twattn.launch_core(q, k, v, bias, mask, hd ** -0.5, out)
            want = twattn.window_attention_plain(q, k, v, bias, mask, hd ** -0.5)
            torch.testing.assert_close(out.float(), want.float(), atol=_tol(dtype),
                                       rtol=_tol(dtype))


def _r(g, dev):
    def r(*s, scale=1.0):
        return torch.randn(*s, generator=g, device=dev) * scale
    return r


@pytest.mark.cuda
def test_kernel_a_in_f32_matches_plain_on_card(cuda_device):
    r = _r(torch.Generator(device=cuda_device).manual_seed(3), cuda_device)
    m, c, f = 1000, 256, 1024
    args = (r(m, c), 1 + r(c, scale=0.1), r(c, scale=0.1), r(f, c, scale=0.05),
            r(f, scale=0.05), r(c, f, scale=0.05), r(c, scale=0.05), 1e-5)
    for act in ("gelu", "leaky"):
        n0 = tmlp.ln_mlp_residual.launches
        got = tmlp.ln_mlp_residual(*args, act)
        assert tmlp.ln_mlp_residual.launches == n0 + 1 and got.dtype == torch.float32
        torch.testing.assert_close(got, tmlp.ln_mlp_residual_plain(*args, act),
                                   atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("heads,n_masks", [(4, 0), (4, 4), (8, 2), (2, 1)])
def test_kernels_b_c_at_every_dtype_and_head_dim_on_card(cuda_device, dtype, heads, n_masks):
    """B and C at head dims 64, 32 and 128 (C = 256), with and without a
    mask, in both element types."""
    r = _r(torch.Generator(device=cuda_device).manual_seed(heads + n_masks), cuda_device)
    bn, w, c = 5, 512, 256
    mask = None if n_masks == 0 else torch.where(
        torch.rand(n_masks, w, w, device=cuda_device) < 0.1, -100.0, 0.0)
    x, qs = r(bn, w, c).to(dtype), r(bn, w, c).to(dtype)
    ln = (1 + r(c, scale=0.1), r(c, scale=0.1))
    rel = r(heads, w, w, scale=0.2)
    wp, bp = r(c, c, scale=0.05).to(dtype), r(c, scale=0.05)
    tol = _tol(dtype)
    self_args = (x, *ln, r(3 * c, c, scale=0.05).to(dtype), r(3 * c, scale=0.05), rel, mask,
                 wp, bp, heads, 1e-5)
    torch.testing.assert_close(tswin.attn_sublayer_self(*self_args).float(),
                               tswin.attn_sublayer_self_plain(*self_args).float(),
                               atol=tol, rtol=tol)
    cross_args = (x, qs, *ln, r(c, c, scale=0.05).to(dtype), r(c, scale=0.05),
                  r(2 * c, c, scale=0.05).to(dtype), r(2 * c, scale=0.05), rel, mask, wp, bp,
                  heads, 1e-5)
    torch.testing.assert_close(tswin.attn_sublayer_cross(*cross_args).float(),
                               tswin.attn_sublayer_cross_plain(*cross_args).float(),
                               atol=tol, rtol=tol)


def _context(rng, n, max_level=12):
    data = np.zeros((1, n, 4, 3), np.int32)
    data[..., 0] = rng.integers(1, max_level, (1, n, 4))
    data[..., 1] = rng.integers(1, 9, (1, n, 4))
    data[..., 2] = rng.integers(0, 255, (1, n, 4))
    data[:, :, 3, 2] = 255
    return data, rng.random((1, n, 3)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ehem_phases_through_the_kernels_match_plain_on_card(cuda_device, dtype, monkeypatch):
    """Phase 1 and phase 2 of an EHEM with pallas_attn on, through kernels
    A, B, C and E (stage 0 at C = 256, head dim 64, takes B and C; the
    192-wide stages, head dim 48, take E), against the same model with
    every sublayer on its plain version.  f32 within F32_TOL-scaled
    logits; bf16 runs and stays finite (its roundings compound over the
    layers, so its kernels are held one by one above)."""
    from scp_tpu_torch.models.ehem import EHEM

    torch.manual_seed(0)
    model = EHEM(self_depths=(2, 2), cross_depths=(2, 1), embed_dim=192, num_heads=4,
                 window_size=128, mlp_ratio=2.0, knn_k=4, static_knn=True, pallas_attn=True,
                 dtype=dtype, device="cuda")
    with torch.no_grad():
        for p in model.parameters():
            p.copy_((torch.randn_like(p, dtype=torch.float32) * 0.05).to(p.dtype))
    rng = np.random.default_rng(5)
    data, pos = (torch.from_numpy(a).to(cuda_device) for a in _context(rng, 512))
    occ = torch.from_numpy(rng.integers(0, 255, (1, 256)).astype(np.int32)).to(cuda_device)

    def phases():
        l1, f1, f2 = model.decode_phase1(data, pos)
        return l1, model.decode_phase2(f1, f2, occ, False)

    ops = (tmlp.ln_mlp_residual, tswin.attn_sublayer_self, tswin.attn_sublayer_cross,
           twattn.window_attention)
    for op in ops:
        op.launches = 0
    got = phases()
    assert all(op.launches > 0 for op in ops), [op.launches for op in ops]
    monkeypatch.setattr(tmlp, "ln_mlp_residual", tmlp.ln_mlp_residual_plain)
    monkeypatch.setattr(tswin, "attn_sublayer_self", tswin.attn_sublayer_self_plain)
    monkeypatch.setattr(tswin, "attn_sublayer_cross", tswin.attn_sublayer_cross_plain)
    monkeypatch.setattr(twattn, "window_attention", twattn.window_attention_plain)
    want = phases()
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-3)


# ---- the Hopper GEMMs: B/C's projection GEMM and A's fused kernel ----------

GEMM_MS = [1, 63, 64, 65, 129, 1000, 8193]  # ragged tiles, one row, more rows than SMs x 64
# (LN prologue, residual, activation): every epilogue the sublayers use and
# the two activations
GEMM_VARIANTS = [(True, False, None), (False, True, None), (True, False, "gelu"),
                 (False, True, "leaky"), (True, True, "gelu")]


def _gemm_args(dev, seed, m, n, k):
    r = _r(torch.Generator(device=dev).manual_seed(seed), dev)
    return (r(m, k).bfloat16(), r(n, k, scale=0.05).bfloat16(), r(n, scale=0.05),
            (1 + r(k, scale=0.1), r(k, scale=0.1)), r(m, n).bfloat16())


def _twice_and_plain(fn, plain, args, kwargs):
    """Two launches must give identical bits (the rANS stream needs the same
    logits on both sides); both within TOL of the plain version."""
    got = fn(*args, **kwargs)
    again = fn(*args, **kwargs)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), plain(*args, **kwargs).float(), atol=TOL, rtol=TOL)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("m", GEMM_MS)
@pytest.mark.parametrize("n", [256, 512, 768, 1024])
def test_proj_gemm_matches_plain_and_repeats_bitwise_on_card(cuda_device, m, n):
    from scp_tpu_torch.ops import proj_gemm

    a, w, b, ln, resid = _gemm_args(cuda_device, m + n, m, n, 256)
    for use_ln, use_resid, act in GEMM_VARIANTS:
        n0 = proj_gemm.linear.arms["sm90"]
        _twice_and_plain(proj_gemm.linear, proj_gemm.linear_plain, (a, w, b),
                         dict(act=act, ln=ln if use_ln else None,
                              resid=resid if use_resid else None))
        assert proj_gemm.linear.arms["sm90"] == n0 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 128, 192])
def test_proj_gemm_at_depths_under_256_on_card(cuda_device, k):
    from scp_tpu_torch.ops import proj_gemm

    for m, n in ((65, 64), (1000, 192), (8193, 320)):
        a, w, b, ln, resid = _gemm_args(cuda_device, k + m, m, n, k)
        _twice_and_plain(proj_gemm.linear, proj_gemm.linear_plain, (a, w, b),
                         dict(act="gelu", ln=ln, resid=resid))


@pytest.mark.cuda
def test_proj_gemm_writes_a_column_slice_of_a_wider_buffer_on_card(cuda_device):
    """B's qkv layout: the output a (M, C) column slice at row stride 3C;
    the columns around it stay as they were."""
    from scp_tpu_torch.ops import proj_gemm

    m, c = 1000, 256
    a, w, b, ln, _ = _gemm_args(cuda_device, 7, m, c, c)
    buf = torch.full((m, 3 * c), 7.0, dtype=torch.bfloat16, device=cuda_device)
    proj_gemm.linear(a, w, b, ln=ln, out=buf[:, c:2 * c])
    torch.testing.assert_close(buf[:, c:2 * c].float(),
                               proj_gemm.linear_plain(a, w, b, ln=ln).float(), atol=TOL, rtol=TOL)
    assert (buf[:, :c] == 7.0).all() and (buf[:, 2 * c:] == 7.0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [320, 384, 512])
def test_proj_gemm_past_256_deep_keeps_the_wmma_kernel_on_card(cuda_device, k):
    from scp_tpu_torch.ops import proj_gemm

    assert proj_gemm.arm(512, k) == "wmma"
    a, w, b, ln, resid = _gemm_args(cuda_device, k, 1000, 512, k)
    n0 = proj_gemm.linear.arms["wmma"]
    _twice_and_plain(proj_gemm.linear, proj_gemm.linear_plain, (a, w, b),
                     dict(act="gelu", ln=ln, resid=resid))
    assert proj_gemm.linear.arms["wmma"] == n0 + 2


def _mlp_args(dev, seed, m, c, f):
    r = _r(torch.Generator(device=dev).manual_seed(seed), dev)
    return (r(m, c).bfloat16(), 1 + r(c, scale=0.1), r(c, scale=0.1),
            r(f, c, scale=0.05).bfloat16(), r(f, scale=0.05),
            r(c, f, scale=0.05).bfloat16(), r(c, scale=0.05), 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("m", GEMM_MS)
@pytest.mark.parametrize("f", [512, 1024])
def test_fused_mlp_matches_plain_and_repeats_bitwise_on_card(cuda_device, m, f):
    args = _mlp_args(cuda_device, m + f, m, 256, f)
    for act in ("gelu", "leaky"):
        n0 = tmlp.ln_mlp_residual.arms["sm90"]
        _twice_and_plain(tmlp.ln_mlp_residual, tmlp.ln_mlp_residual_plain, (*args, act), {})
        assert tmlp.ln_mlp_residual.arms["sm90"] == n0 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("c,f", [(64, 256), (128, 512), (192, 384), (256, 64)])
def test_fused_mlp_at_every_width_it_takes_on_card(cuda_device, c, f):
    for m in (65, 1000):
        _twice_and_plain(tmlp.ln_mlp_residual, tmlp.ln_mlp_residual_plain,
                         (*_mlp_args(cuda_device, c + m, m, c, f), "gelu"), {})


@pytest.mark.cuda
def test_mlp_past_256_wide_keeps_the_wmma_kernels_on_card(cuda_device):
    assert tmlp.kernel_arm(384, torch.bfloat16) == "wmma"
    n0 = tmlp.ln_mlp_residual.arms["wmma"]
    _twice_and_plain(tmlp.ln_mlp_residual, tmlp.ln_mlp_residual_plain,
                     (*_mlp_args(cuda_device, 3, 1000, 384, 768), "gelu"), {})
    assert tmlp.ln_mlp_residual.arms["wmma"] == n0 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads", [(256, 4), (384, 4)])
def test_kernels_b_c_repeat_bitwise_on_either_gemm_arm_on_card(cuda_device, c, heads):
    """B and C at C = 256 (the Hopper GEMM) and C = 384 (the WMMA GEMM):
    two launches identical, within TOL of the plain versions."""
    r = _r(torch.Generator(device=cuda_device).manual_seed(c), cuda_device)
    bn, w = 3, 256
    arm = tswin.gemm_arm(c, torch.bfloat16)
    assert arm == ("sm90" if c <= 256 else "wmma")
    mask = torch.where(torch.rand(2, w, w, device=cuda_device) < 0.1, -100.0, 0.0)
    x, qs = r(bn, w, c).bfloat16(), r(bn, w, c).bfloat16()
    ln = (1 + r(c, scale=0.1), r(c, scale=0.1))
    rel = r(heads, w, w, scale=0.2)
    wp, bp = r(c, c, scale=0.05).bfloat16(), r(c, scale=0.05)
    n_self, n_cross = tswin.attn_sublayer_self.arms[arm], tswin.attn_sublayer_cross.arms[arm]
    _twice_and_plain(tswin.attn_sublayer_self, tswin.attn_sublayer_self_plain,
                     (x, *ln, r(3 * c, c, scale=0.05).bfloat16(), r(3 * c, scale=0.05), rel,
                      mask, wp, bp, heads, 1e-5), {})
    _twice_and_plain(tswin.attn_sublayer_cross, tswin.attn_sublayer_cross_plain,
                     (x, qs, *ln, r(c, c, scale=0.05).bfloat16(), r(c, scale=0.05),
                      r(2 * c, c, scale=0.05).bfloat16(), r(2 * c, scale=0.05), rel, mask, wp,
                      bp, heads, 1e-5), {})
    assert tswin.attn_sublayer_self.arms[arm] == n_self + 2
    assert tswin.attn_sublayer_cross.arms[arm] == n_cross + 2


# ---- the autograd Functions of the training path ---------------------------


def _function_grads(fn, args, diff, launcher):
    """Output and gradients of fn.apply(*args, plain) through the kernel
    and through the plain version, under a loss whose upstream gradient
    depends on the output (so the two backwards see different cotangents).
    The kernel pass must launch exactly once."""
    got = []
    for plain in (False, True):
        leaves = [a.detach().clone().requires_grad_(True) if i in diff else a
                  for i, a in enumerate(args)]
        n0 = launcher.launches
        out = fn.apply(*leaves, plain)
        assert launcher.launches == n0 + (0 if plain else 1)
        w = torch.linspace(-1, 1, out.numel(), device=out.device).reshape(out.shape)
        (out.float().square() * w).sum().backward()
        got.append((out.detach(), [leaves[i].grad for i in diff]))
    return got


def _assert_function_grads(got, dtype):
    (out_k, g_k), (out_p, g_p) = got
    tol = _tol(dtype)
    torch.testing.assert_close(out_k.float(), out_p.float(), atol=tol, rtol=tol)
    for a, b in zip(g_k, g_p):
        assert a is not None and a.dtype == b.dtype and bool(a.any())
        scale = max(1.0, float(b.float().abs().max()))
        torch.testing.assert_close(a.float(), b.float(), atol=tol * scale, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_function_a_gradients_kernel_vs_plain_on_card(cuda_device, dtype):
    r = _r(torch.Generator(device=cuda_device).manual_seed(11), cuda_device)
    m, c, f = 1000, 256, 1024
    args = (r(m, c).to(dtype), 1 + r(c, scale=0.1), r(c, scale=0.1),
            r(f, c, scale=0.05).to(dtype), r(f, scale=0.05), r(c, f, scale=0.05).to(dtype),
            r(c, scale=0.05), 1e-5, "gelu")
    got = _function_grads(tmlp.LnMlpResidual, args, range(7), tmlp.ln_mlp_residual)
    _assert_function_grads(got, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n_masks", [0, 2])
def test_functions_b_c_gradients_kernel_vs_plain_on_card(cuda_device, dtype, n_masks):
    r = _r(torch.Generator(device=cuda_device).manual_seed(12), cuda_device)
    bn, w, c, heads = 4, 512, 256, 4
    rel = r(heads, w, w, scale=0.5)
    mask = (None if not n_masks else
            torch.where(r(n_masks, w, w) > 1.0, -100.0, 0.0).to(cuda_device))
    x, qs = r(bn, w, c).to(dtype), r(bn, w, c).to(dtype)
    ln = (1 + r(c, scale=0.1), r(c, scale=0.1))
    wp, bp = r(c, c, scale=0.05).to(dtype), r(c, scale=0.05)
    self_args = (x, *ln, r(3 * c, c, scale=0.05).to(dtype), r(3 * c, scale=0.05), rel, mask,
                 wp, bp, heads, 1e-5)
    got = _function_grads(tswin.AttnSublayerSelf, self_args, [0, 1, 2, 3, 4, 5, 7, 8],
                          tswin.attn_sublayer_self)
    _assert_function_grads(got, dtype)
    cross_args = (x, qs, *ln, r(c, c, scale=0.05).to(dtype), r(c, scale=0.05),
                  r(2 * c, c, scale=0.05).to(dtype), r(2 * c, scale=0.05), rel, mask, wp, bp,
                  heads, 1e-5)
    got = _function_grads(tswin.AttnSublayerCross, cross_args,
                          [0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 11], tswin.attn_sublayer_cross)
    _assert_function_grads(got, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_function_e_gradients_kernel_vs_plain_on_card(cuda_device, dtype):
    q, k, v, bias, mask = _core_inputs(cuda_device, 13, 6, 4, 512, 64, 2, dtype, "heads")
    got = _function_grads(twattn.WindowAttention, (q, k, v, bias, mask, 0.125), [0, 1, 2, 3],
                          twattn.window_attention)
    _assert_function_grads(got, dtype)


@pytest.mark.cuda
def test_ehem_training_step_through_the_kernels_matches_plain_on_card(cuda_device):
    """One f32 training forward + backward of a small EHEM with both
    switches on (A, B, C, D, E in the forward), against the same model
    with its seams on their plain versions: loss and every gradient."""
    from scp_tpu_torch.models.ehem import EHEM
    from scp_tpu_torch.models.layers import flax_init_
    from scp_tpu_torch.train.trainer import cross_entropy_bits

    kw = dict(self_depths=(2, 2), cross_depths=(2, 1), embed_dim=128, num_heads=4,
              window_size=128, mlp_ratio=2.0, knn_k=4, static_knn=True, pallas_knn=True,
              pallas_attn=True, device="cuda")
    mk = flax_init_(EHEM(**kw), torch.Generator().manual_seed(0)).train()
    mp = EHEM(**kw, plain_seams=True).train()
    mp.load_state_dict(mk.state_dict())
    rng = np.random.default_rng(6)
    data, pos = (torch.from_numpy(a).to(cuda_device) for a in _context(rng, 2304))
    label = torch.from_numpy(rng.integers(0, 256, (1, 2304))).to(cuda_device)
    ops = (tmlp.ln_mlp_residual, tswin.attn_sublayer_self, tswin.attn_sublayer_cross,
           tknn.knn_topk, twattn.window_attention)
    n0 = [op.launches for op in ops]
    losses = []
    for m in (mk, mp):
        loss = cross_entropy_bits(m(data, pos), label)
        loss.backward()
        losses.append(float(loss.detach()))
        if m is mk:
            assert all(op.launches > n for op, n in zip(ops, n0)), [op.launches for op in ops]
    assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[1])
    gp = dict(mp.named_parameters())
    for name, p in mk.named_parameters():
        assert p.grad is not None, name
        scale = max(1.0, float(gp[name].grad.abs().max()))
        torch.testing.assert_close(p.grad, gp[name].grad, atol=1e-3 * scale, rtol=1e-3,
                                   msg=name)
