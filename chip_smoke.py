"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printed as it ends (any failure exits non-zero):
  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build of the hand-written kernels (one nvcc per source, in parallel);
  2. kernels A (MLP sublayer), B (self attention sublayer) and C (cross
     attention sublayer) against their plain PyTorch versions on the card,
     at the main path's widths (C=256, W=512, 4 heads, F=1024) and at the
     token counts of the L16 cloud's largest level, with the EHEM
     checkpoint's own block weights; kernel D (fused KNN distance +
     top-k) on that level's quantized positions (15, 8192, 3) (its pruned
     arm; index lists identical to the plain version's), on the same rows
     shuffled within each lane (nothing to prune; identical lists too)
     and on random (15, 8192, 192) features, kernel E (window attention) at its
     on-path shape (1, 4, 512, 64) and at (240, 4, 512, 64); times of
     kernel, plain version and, where one PyTorch call computes the same
     function, that call;
  3. the full-width EHEM from checkpoints/ehem_synth_f16_sknn.npz (static
     KNN on), loaded through scp_tpu_torch.weights;
  4. one encode and one decode of the 120,000-point synthetic KITTI-like
     cloud at lidar level 16 (seed 0), with the lossless check; the kernel
     launch counts of that run show the path went through the kernels;
  5. the same roundtrip with the fused-kernel switches on (pallas_knn and
     pallas_attn, scp_tpu's SCP_PALLAS_KNN / SCP_PALLAS_ATTN): kernel D
     builds the position graphs of N >= 2048 rows, kernel E the attention
     of the padded deep Swin stages; lossless, and its bpp within 0.1% of
     phase 4's;
  6. the roundtrip of an f32 EHEM with pallas_attn on: kernels A, B, C and
     E in f32 (CUDA cores, no TF32); lossless, its bpp within 0.1% of the
     f32 figure of scp_tpu_torch/tools/rate_probe.py (plain f32 sublayers).

Phase 2 also holds A, B, C and E in f32 against their plain versions
(atol = rtol = 1e-4), and times the attention core that B, C and E share
at B's layout and token count beside scaled_dot_product_attention.  For
A, B and C it checks that two launches give identical bits, and times
their bf16 products alone: through the port's Hopper GEMM (B, C; A's
fused kernel is its products) and through cuBLAS without LN or epilogue
(`products_library_ms`, F.linear: a yardstick for the products only, so
`library_ms` stays null).  For D's pruned arm it prints the share of the
brute-force (warp, group) pairs scored on both row orders, read from the
kernel's counter; D's bound counts the pairs this input needed.  Phase 1
reads the registers and spills of each Hopper GEMM kernel and of D's
pruned arm from the ptxas -v build log and fails on a spill; phase 4
checks that A, B and C took the Hopper kernels on every launch.

The second-to-last line is the JSON kernel table; the last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX or scp_tpu.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(HERE, "checkpoints", "ehem_synth_f16_sknn.npz")
N_POINTS = 120_000
LIDAR_LEVEL = 16
TOL = 3e-2  # atol = rtol: bf16 outputs (8-bit mantissa), kernel vs plain summation order
F32_TOL = 1e-4  # atol = rtol: f32 outputs, summation order over K <= 1024 (TF32 would miss it)
# kernel D vs its plain version at C > 4: the index lists may differ only
# where the two sum a dot product in other orders and a near tie swaps; the
# exact (f64) distances of both picks agree within KNN_RTOL on every row.
# On positions (C = 3, the pruned arm) the lists must be identical.
KNN_SAME_ROWS = 0.999
KNN_RTOL = 1e-5
BPP_RTOL = 1e-3  # phase 5 vs phase 4: f32 instead of bf16 KNN scores
# phase 4 vs the main path's rate before the attention core was unified
# (chip_smoke.py phase 4 on the H100, PERF.md section 6)
MAIN_PATH_BPP = 18.4428
# phase 6 vs the f32 model with plain sublayers (tools/rate_probe.py, the
# L16 cloud on the H100, PERF.md section 6)
F32_PLAIN_BPP = 18.4245
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # CUDA cores, no tensor cores
PEAK_BYTES = 3.35e12


def say(*args):
    print(*args, flush=True)


def synth_kitti(rng, n):
    """Ring-structured LiDAR-like sweep (the bench.py cloud generator)."""
    beams = 64
    el = np.deg2rad(np.linspace(-24.8, 2.0, beams))[rng.integers(0, beams, n)]
    az = rng.uniform(0, 2 * np.pi, n)
    r = np.clip(rng.gamma(3.0, 8.0, n) + 2.0, 2.0, 120.0)
    x = r * np.cos(el) * np.cos(az)
    y = r * np.cos(el) * np.sin(az)
    z = r * np.sin(el)
    return np.stack([x, y, z], 1)


def cuda_time_ms(fn, reps: int, warm: int = 1) -> float:
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def check_close(name, got, want, tol=TOL):
    err = (got.float() - want.float()).abs()
    bound = tol + tol * want.float().abs()
    max_err = float(err.max())
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    bad = int((err > bound).sum())
    say(f"  {name}: max_abs_err={max_err:.6g} (tolerance atol=rtol={tol}), "
        f"elements over tolerance: {bad}")
    if bad:
        raise AssertionError(f"{name}: {bad} elements over tolerance")
    return max_err


def check_repeat(name, fn):
    """Two launches on the same inputs must give identical bits: the encoder
    and the decoder must see the same logits.  Returns the first output."""
    got = fn()
    again = fn()
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches on the same inputs differ")
    say(f"  {name}: two launches bit-identical")
    return got


def gemm_part(name, calls, flops, library_calls):
    """The sublayer's bf16 products through the port's GEMM kernels alone
    (`calls`: the Hopper GEMM at the sublayer's shapes, with its LN,
    bias and residual) and through cuBLAS without LN or epilogue
    (`library_calls`, F.linear: a yardstick for the products, not the
    same function); times and the GEMM's achieved TFLOP/s."""
    ms = cuda_time_ms(lambda: [c() for c in calls], 10)
    lib = cuda_time_ms(lambda: [c() for c in library_calls], 10)
    say(f"  {name} GEMM part: {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), cuBLAS products "
        f"{lib:.4f} ms ({flops / lib / 1e9:.1f} TFLOP/s)")
    return dict(gemm_ms=ms, gemm_tflops=flops / ms / 1e9, products_library_ms=lib)


def check_knn(name, got, again, want, feats, min_rows=KNN_SAME_ROWS):
    """Kernel D's picks against the plain version's: identical index lists
    on >= min_rows of the rows; returns the largest difference of their
    sorted f64 distances."""
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches on the same input differ")
    same = float((got == want).all(-1).double().mean())
    f = feats.double()
    max_err, bad = 0.0, 0
    for b in range(f.shape[0]):
        def dists(idx):
            return ((f[b][idx[b]] - f[b][:, None]) ** 2).sum(-1).sort(-1).values

        dg, dw = dists(got), dists(want)
        err = (dg - dw).abs()
        max_err = max(max_err, float(err.max()))
        bad += int((err > KNN_RTOL * dw).sum())
    say(f"  {name}: identical index lists on {same:.6f} of rows (need >= {min_rows}), "
        f"distances over rtol {KNN_RTOL}: {bad}, max abs distance difference {max_err:.6g}")
    if same < min_rows or bad:
        raise AssertionError(f"{name}: kernel picks disagree with the plain version")
    return max_err


def level_positions(slices, lanes: int, width: int):
    """The positions the largest level's (lanes, width) call gives the
    position graph: pad rows at 0, normalized and quantized to 16 bits as
    EHEMCodec._phase1 does, in bf16 as the model casts them."""
    from scp_tpu_torch.codec.ehem_codec import EHEMCodec

    li = int(np.argmax(slices.level_sizes))
    pos = np.zeros((lanes * width, 3), np.int64)
    n = min(len(slices.pos_int[li]), lanes * width)
    pos[:n] = slices.pos_int[li][:n]
    lo, scale = EHEMCodec._norm_params(slices.pos_mm[li], slices.max_level, True)
    f32 = torch.float32
    pf = (torch.from_numpy(pos) - lo).to(f32) * torch.tensor(scale, dtype=f32)
    pu = torch.round(torch.clamp(pf, 0.0, 1.0) * torch.tensor(65535.0, dtype=f32))
    pq = pu.to(torch.int32).to(f32) * torch.tensor(np.float32(1.0 / 65535.0))
    return pq.reshape(lanes, width, 3).to("cuda", torch.bfloat16)


def bound_ms(n_bytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def f32_row(name, kernel, plain, args, n_bytes, flops, reps=3):
    """A kernel in f32 against its plain version (F32_TOL): error, times
    and the f32 bound (bytes doubled from bf16, CUDA-core peak)."""
    got = kernel(*args)
    torch.cuda.synchronize()
    err = check_close(f"{name} in f32", got, plain(*args), F32_TOL)
    b, by = bound_ms(n_bytes, flops, PEAK_F32_FLOPS)
    return dict(f32_max_abs_err=err, f32_ms=cuda_time_ms(lambda: kernel(*args), reps),
                f32_plain_ms=cuda_time_ms(lambda: plain(*args), 2), f32_bound_ms=b,
                f32_bound_by=by)


def f32_args(args):
    """bf16 tensors of an argument tuple as f32 (weights, activations)."""
    return tuple(a.float() if torch.is_tensor(a) and a.dtype == torch.bfloat16 else a
                 for a in args)


def n_masks(mask):
    return 0 if mask is None else mask.shape[0]


def sdpa_bias(bias, mask, n_win):
    """SDPA's attn_mask for the same logits: bias (+ window n's mask), bf16."""
    if mask is None:
        return bias[None].to(torch.bfloat16)
    mask_b = mask[torch.arange(n_win, device=mask.device) % mask.shape[0]]
    return (bias[None] + mask_b[:, None]).to(torch.bfloat16)


def core_at_b_layout(rand, n_win, w, c, h, bias, mask):
    """The attention core B, C and E share, at B's layout (q, k, v the
    column-strided (BN*W, 3C) projection buffer) and token count, against
    its plain version and beside SDPA on the same inputs (contiguous
    copies, the bf16 bias + mask as attn_mask)."""
    from scp_tpu_torch.ops import window_attn

    hd = c // h
    qkv = rand(n_win * w, 3 * c)
    q, k, v = (qkv[:, i * c:(i + 1) * c].reshape(n_win, w, h, hd).permute(0, 2, 1, 3)
               for i in range(3))
    att = torch.empty((n_win * w, c), dtype=qkv.dtype, device=qkv.device)
    out = att.reshape(n_win, w, h, hd).permute(0, 2, 1, 3)
    args = (q, k, v, bias, mask, hd ** -0.5)
    window_attn.launch_core(*args, out)
    torch.cuda.synchronize()
    err = check_close(f"B core at B's layout ({n_win}, {h}, {w}, {hd}), {mask.shape[0]} masks",
                      out, window_attn.window_attention_plain(*args))
    sdpa_mask = sdpa_bias(bias, mask, n_win)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    nb = 4 * n_win * w * c * 2 + h * w * w * 4 + mask.numel() * 4
    b, by = bound_ms(nb, 4 * n_win * h * w * w * hd)
    row = dict(
        core_max_abs_err=err, core_ms=cuda_time_ms(lambda: window_attn.launch_core(*args, out), 10),
        core_plain_ms=cuda_time_ms(lambda: window_attn.window_attention_plain(*args), 3),
        core_library_ms=cuda_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qc, kc, vc, attn_mask=sdpa_mask, scale=hd ** -0.5), 10),
        core_bound_ms=b, core_bound_by=by,
    )
    del sdpa_mask
    return row


def kernel_phase(model, gen, slices):
    """Phase 2: each kernel against its plain version; returns table rows."""
    from scp_tpu_torch.models.swin1d import _mask_tensor
    from scp_tpu_torch.ops import knn, knn_topk, proj_gemm, window_attn
    from scp_tpu_torch.ops import mlp as mlp_ops
    from scp_tpu_torch.ops import swin_attn

    F = torch.nn.functional
    dev = torch.device("cuda")
    c, w, h, f = 256, 512, 4, 1024
    lanes, width = 15, 8192  # the L16 cloud's largest level: one (15, 8192) call
    m_self = lanes * width  # phase-1 stage-0 tokens
    m_cross = lanes * width // 2  # phase-2 stage-0 tokens
    rows = {}

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    # ---- A: MLP sublayer, phase-1 stage 0 block 0 weights
    blk = model.swin_self.stage_0.block_0
    x = rand(m_self, c)
    args = (x, blk.norm2.weight, blk.norm2.bias, blk.mlp1.weight, blk.mlp1.bias,
            blk.mlp2.weight, blk.mlp2.bias, 1e-5, "gelu")
    got = check_repeat("A ln_mlp_residual (gelu)", lambda: mlp_ops.ln_mlp_residual(*args))
    err = check_close("A ln_mlp_residual (gelu)", got, mlp_ops.ln_mlp_residual_plain(*args))
    ms = cuda_time_ms(lambda: mlp_ops.ln_mlp_residual(*args), 10)
    plain = cuda_time_ms(lambda: mlp_ops.ln_mlp_residual_plain(*args), 3)
    nb = 2 * m_self * c * 2 + 2 * c * f * 2 + 4 * (3 * c + f)
    flops = 2 * 2 * m_self * c * f
    b, by = bound_ms(nb, flops)
    lib = cuda_time_ms(lambda: F.linear(F.linear(x, blk.mlp1.weight), blk.mlp2.weight), 10)
    say(f"  A: {flops / ms / 1e9:.1f} TFLOP/s fused; cuBLAS products {lib:.4f} ms "
        f"({flops / lib / 1e9:.1f} TFLOP/s)")
    rows["A"] = dict(
        name="ln_mlp_residual", route="cuda", source="scp_tpu_torch/ops/csrc/mlp.cu",
        replaces="scp_tpu/ops/pallas_mlp.py:96", max_abs_err=err, ms=ms,
        plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None,
        tokens=m_self, gemm_ms=ms, gemm_tflops=flops / ms / 1e9, products_library_ms=lib,
        **f32_row("A ln_mlp_residual (gelu)", mlp_ops.ln_mlp_residual,
                                 mlp_ops.ln_mlp_residual_plain, f32_args(args), 2 * nb,
                                 2 * 2 * m_self * c * f),
    )

    # ---- B: self attention sublayer, unshifted (block 0) and shifted (block 1)
    errs, ms_list, plain_list = [], [], []
    for bi, shift in ((0, 0), (1, w // 2)):
        blk = getattr(model.swin_self.stage_0, f"block_{bi}")
        at = blk.attn
        mask = _mask_tensor(width, w, shift, dev) if shift else None  # as the seam passes it
        xw = rand(m_self // w, w, c)
        args = (xw, blk.norm1.weight, blk.norm1.bias, at.qkv.weight, at.qkv.bias,
                at.rel_bias(), mask, at.proj.weight, at.proj.bias, h, 1e-5)
        tag = f"B attn_sublayer_self (shift {shift}, {n_masks(mask)} masks)"
        got = check_repeat(tag, lambda: swin_attn.attn_sublayer_self(*args))
        errs.append(check_close(tag, got, swin_attn.attn_sublayer_self_plain(*args)))
        ms_list.append(cuda_time_ms(lambda: swin_attn.attn_sublayer_self(*args), 10))
        plain_list.append(cuda_time_ms(lambda: swin_attn.attn_sublayer_self_plain(*args), 2))
    n_win = m_self // w
    flops = 2 * m_self * c * 3 * c + 4 * n_win * w * w * c + 2 * m_self * c * c
    nb = 2 * m_self * c * 2 + 4 * c * c * 2 + h * w * w * 4 + mask.numel() * 4
    b, by = bound_ms(nb, flops)
    x2, a2 = xw.reshape(m_self, c), rand(m_self, c)
    ln = (blk.norm1.weight, blk.norm1.bias)
    gemm_b = gemm_part(
        "B", (lambda: proj_gemm.linear(x2, at.qkv.weight, at.qkv.bias, ln=ln),
              lambda: proj_gemm.linear(a2, at.proj.weight, at.proj.bias, resid=x2)),
        2 * m_self * c * 4 * c,
        (lambda: F.linear(x2, at.qkv.weight), lambda: F.linear(a2, at.proj.weight)))
    rows["B"] = dict(
        name="attn_sublayer_self", route="cuda", source="scp_tpu_torch/ops/csrc/swin_attn.cu",
        replaces="scp_tpu/ops/pallas_swin.py:63", max_abs_err=max(errs), ms=ms_list[1],
        plain_ms=plain_list[1], bound_ms=b, bound_by=by, library_ms=None,
        tokens=m_self, ms_unshifted=ms_list[0], **gemm_b,
        **f32_row(f"B attn_sublayer_self (shift {w // 2})", swin_attn.attn_sublayer_self,
                  swin_attn.attn_sublayer_self_plain, f32_args(args), 2 * nb, flops),
        **core_at_b_layout(rand, n_win, w, c, h, blk.attn.rel_bias(), mask),
    )

    # ---- C: cross attention sublayer, phase-2 stage 0 block 1 (shifted)
    blk = model.swin_cross.stage_0.block_1
    at = blk.attn
    mask = _mask_tensor(width // 2, w, w // 2, dev)
    xw, qs = rand(m_cross // w, w, c), rand(m_cross // w, w, c)
    args = (xw, qs, blk.norm1.weight, blk.norm1.bias, at.query.weight, at.query.bias,
            at.kv.weight, at.kv.bias, at.rel_bias(), mask, at.proj.weight, at.proj.bias,
            h, 1e-5)
    tag = f"C attn_sublayer_cross (shift {w // 2}, {mask.shape[0]} masks)"
    got = check_repeat(tag, lambda: swin_attn.attn_sublayer_cross(*args))
    err = check_close(tag, got, swin_attn.attn_sublayer_cross_plain(*args))
    ms = cuda_time_ms(lambda: swin_attn.attn_sublayer_cross(*args), 10)
    plain = cuda_time_ms(lambda: swin_attn.attn_sublayer_cross_plain(*args), 2)
    n_win = m_cross // w
    flops = 2 * m_cross * c * 4 * c + 4 * n_win * w * w * c
    nb = 3 * m_cross * c * 2 + 4 * c * c * 2 + h * w * w * 4 + mask.numel() * 4
    b, by = bound_ms(nb, flops)
    x2, q2, a2 = xw.reshape(m_cross, c), qs.reshape(m_cross, c), rand(m_cross, c)
    ln = (blk.norm1.weight, blk.norm1.bias)
    gemm_c = gemm_part(
        "C", (lambda: proj_gemm.linear(q2, at.query.weight, at.query.bias, ln=ln),
              lambda: proj_gemm.linear(x2, at.kv.weight, at.kv.bias, ln=ln),
              lambda: proj_gemm.linear(a2, at.proj.weight, at.proj.bias, resid=x2)),
        2 * m_cross * c * 4 * c,
        (lambda: F.linear(q2, at.query.weight), lambda: F.linear(x2, at.kv.weight),
         lambda: F.linear(a2, at.proj.weight)))
    rows["C"] = dict(
        name="attn_sublayer_cross", route="cuda", source="scp_tpu_torch/ops/csrc/swin_attn.cu",
        replaces="scp_tpu/ops/pallas_swin.py:96", max_abs_err=err, ms=ms,
        plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None, tokens=m_cross, **gemm_c,
        **f32_row(f"C attn_sublayer_cross (shift {w // 2})", swin_attn.attn_sublayer_cross,
                  swin_attn.attn_sublayer_cross_plain, f32_args(args), 2 * nb, flops),
    )

    # ---- D: fused KNN distance + top-k, k = 20: the L16 position graph of
    # the (15, 8192) call (the pruned arm), the same rows shuffled within
    # each lane (nothing to prune), then the dynamic graph's widest
    # features (the brute-force arm)
    k = 20
    d_shapes = {}
    pos = level_positions(slices, lanes, width)
    perm = torch.randperm(width, generator=gen, device=dev)
    for tag, feats in (
        ("positions", pos),
        ("shuffled", pos[:, perm].contiguous()),
        ("c192", rand(lanes, width, 192)),
    ):
        b_, n_, c_ = feats.shape
        pruned = c_ <= knn_topk.PRUNED_MAX_C
        stats = torch.zeros(1, dtype=torch.int64, device=dev) if pruned else None
        got = knn_topk.knn_topk(feats, k, stats=stats)
        again = knn_topk.knn_topk(feats, k)
        want = knn_topk.knn_topk_plain(feats, k)
        torch.cuda.synchronize()
        err = check_knn(f"D knn_topk {tuple(feats.shape)} {tag}", got, again, want, feats,
                        min_rows=1.0 if pruned else KNN_SAME_ROWS)
        # the work this input needs: the (warp, group) pairs the pruned arm
        # scored (8 queries x 32 keys each), every pair for the wide arm
        total = b_ * -(-n_ // knn_topk.QPW) * -(-n_ // knn_topk.GROUP)
        visited = int(stats) if pruned else total
        pairs = visited * knn_topk.QPW * knn_topk.GROUP if pruned else b_ * n_ * n_
        b, by = bound_ms(b_ * n_ * c_ * 2 + b_ * n_ * k * 8, 2 * pairs * c_)
        d_shapes[tag] = dict(
            err=err, ms=cuda_time_ms(lambda: knn_topk.knn_topk(feats, k), 10), bound=b, by=by,
            visited=visited, total=total,
        )
        if tag != "shuffled":  # the same function of the same rows as "positions"
            d_shapes[tag].update(
                plain=cuda_time_ms(lambda: knn_topk.knn_topk_plain(feats, k), 3),
                main=cuda_time_ms(lambda: knn.knn_indices(feats, k), 3))
        if pruned:
            say(f"  D {tag}: scored {visited} of {total} (warp, group) pairs, "
                f"share {visited / total:.4f} of the brute-force work")
    dp, ds, dw = d_shapes["positions"], d_shapes["shuffled"], d_shapes["c192"]
    rows["D"] = dict(
        name="knn_topk", route="cuda", source="scp_tpu_torch/ops/csrc/knn_topk.cu",
        replaces="scp_tpu/ops/pallas_knn.py:59",
        max_abs_err=max(dp["err"], ds["err"], dw["err"]), ms=dp["ms"], plain_ms=dp["plain"],
        bound_ms=dp["bound"], bound_by=dp["by"], library_ms=None,
        library_note="no one PyTorch call computes distance + top-k (torch.cdist, then "
                     "torch.topk, is two)",
        shape=[lanes, width, 3], main_path_knn_ms=dp["main"],
        groups_visited=dp["visited"], groups_visited_shuffled=ds["visited"],
        groups_total=dp["total"], groups_visited_share=dp["visited"] / dp["total"],
        groups_visited_shuffled_share=ds["visited"] / ds["total"],
        shuffled_ms=ds["ms"], shuffled_bound_ms=ds["bound"], shuffled_bound_by=ds["by"],
        c192_shape=[lanes, width, 192], c192_ms=dw["ms"], c192_plain_ms=dw["plain"],
        c192_bound_ms=dw["bound"], c192_bound_by=dw["by"], c192_main_path_knn_ms=dw["main"],
    )

    # ---- E: window attention at its on-path shape (one padded window of
    # the 256-token stage, unshifted) and at B's token count, shifted
    blk = model.swin_self.stage_3.block_0
    bias = blk.attn.rel_bias()
    e_shapes = {}
    hd = c // h
    for tag, bn, mask in (
        ("on_path", 1, None),
        ("bn240", m_self // w, _mask_tensor(2 * w, w, w // 2, dev)),
    ):
        q, k_, v = (rand(bn, h, w, hd) for _ in range(3))
        args = (q, k_, v, bias, mask, hd ** -0.5)
        got = window_attn.window_attention(*args)
        torch.cuda.synchronize()
        err = check_close(f"E window_attention ({bn}, {h}, {w}, {hd}), {n_masks(mask)} masks",
                          got, window_attn.window_attention_plain(*args))
        sdpa_mask = sdpa_bias(bias, mask, bn)
        nb = 4 * bn * h * w * hd * 2 + h * w * w * 4 + n_masks(mask) * w * w * 4
        b, by = bound_ms(nb, 4 * bn * h * w * w * hd)
        e_shapes[tag] = dict(
            err=err, ms=cuda_time_ms(lambda: window_attn.window_attention(*args), 10),
            plain=cuda_time_ms(lambda: window_attn.window_attention_plain(*args), 3),
            lib=cuda_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k_, v, attn_mask=sdpa_mask, scale=hd ** -0.5), 10),
            bound=b, by=by, tokens=bn * w, args=args, nb=nb,
        )
        del sdpa_mask
    ep, eb = e_shapes["on_path"], e_shapes["bn240"]
    e32 = f32_row(f"E window_attention {tuple(eb['args'][0].shape)}",
                  window_attn.window_attention, window_attn.window_attention_plain,
                  f32_args(eb["args"]), 2 * eb["nb"], 4 * eb["tokens"] * h * w * hd)
    rows["E"] = dict(
        name="window_attention", route="cuda", source="scp_tpu_torch/ops/csrc/window_attn.cu",
        replaces="scp_tpu/ops/pallas_attn.py:41", max_abs_err=max(ep["err"], eb["err"]),
        ms=ep["ms"], plain_ms=ep["plain"], bound_ms=ep["bound"], bound_by=ep["by"],
        library_ms=ep["lib"], library_note="scaled_dot_product_attention with the bf16 "
        "bias + mask as attn_mask", shape=[1, h, w, hd], tokens=ep["tokens"],
        bn240_shape=[m_self // w, h, w, hd], bn240_ms=eb["ms"], bn240_plain_ms=eb["plain"],
        bn240_bound_ms=eb["bound"], bn240_bound_by=eb["by"], bn240_library_ms=eb["lib"],
        f32_shape=[m_self // w, h, w, hd], **e32,
    )
    return rows


def check_spills(rows, what):
    """Prints each kernel's registers and spills; fails on a spill, or when
    the build logs hold no kernel of `what`."""
    for k, r in sorted(rows.items()):
        say(f"  {k}: {r['registers']} registers at entry, spill stores {r['spill_stores']} B, "
            f"spill loads {r['spill_loads']} B")
        if r["spill_stores"] or r["spill_loads"]:
            raise AssertionError(f"{k} spills registers")
    if not rows:
        raise AssertionError(f"no {what} kernel in the build logs")
    return rows


def sm90_resources(cuda):
    """Registers and spills of the Hopper GEMM kernels (ptxas -v, from the
    build log); fails on any spill."""
    rows = {}
    for src in ("mlp.cu", "swin_attn.cu"):
        for r in cuda.ptxas_report(src, "sm90"):
            name = "mlp_sm90" if "mlp_sm90" in r["kernel"] else "gemm_sm90"
            targs = re.findall(r"L[ib](\d+)", r["kernel"].split("EEEv", 1)[0])
            rows[f"{name}<{','.join(targs)}>"] = r
    return check_spills(rows, "Hopper GEMM")


def knn_resources(cuda):
    """Registers and spills of kernel D's pruned arm: the search, by row
    width in floats (4: up to 3 coordinates, 8: 4), and the pre-pass, by
    element type and C; fails on any spill."""
    rows = {}
    for name in ("knn_topk_pruned", "knn_topk_boxes"):
        for r in cuda.ptxas_report("knn_topk.cu", name):
            targs = re.findall(r"Li(\d+)E", r["kernel"])
            if name == "knn_topk_boxes":
                targs.insert(0, "bf16" if "bfloat16" in r["kernel"] else "f32")
            rows[f"{name}<{','.join(targs)}>"] = r
    return check_spills(rows, "pruned KNN")


def roundtrip(codec, slices, counted):
    """One cold encode and one cold decode with the lossless check; the
    kernel counts are set to 0 just before and read just after."""
    for fn in counted:
        fn.launches = 0
        for arm in getattr(fn, "arms", {}):
            fn.arms[arm] = 0
    torch.cuda.synchronize()
    t0 = time.time()
    stream, bits, _ = codec.encode_to_stream(slices)
    torch.cuda.synchronize()
    t_enc = time.time() - t0
    t0 = time.time()
    dec = codec.new_stream_decoder(stream, codec.coding_params())
    codes = codec.decode(dec, slices.max_level, np.array(slices.pos_mm, np.int64),
                         angular=True, ground_truth=slices.occ_stream,
                         level_sizes=slices.level_sizes)
    torch.cuda.synchronize()
    t_dec = time.time() - t0
    launches = [fn.launches for fn in counted]
    if codes.shape != slices.occ_stream.shape or not (codes == slices.occ_stream).all():
        raise AssertionError("decode is not lossless")
    bpp = bits / N_POINTS
    if not math.isfinite(bpp) or bits <= 0:
        raise AssertionError(f"bad bit count {bits}")
    return dict(bpp=bpp, bytes=len(stream), encode_s=t_enc, decode_s=t_dec,
                launches=launches)


def main() -> int:
    t_start = time.time()
    if not torch.cuda.is_available():
        say("chip_smoke: no CUDA device available; this smoke runs on the card only")
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    say(smi)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    from scp_tpu_torch.codec.ehem_codec import EHEMCodec
    from scp_tpu_torch.codec.slices import split_levels
    from scp_tpu_torch.core.preprocess import kitti_qs, preprocess_points
    from scp_tpu_torch.models.ehem import EHEM
    from scp_tpu_torch.ops import _cuda, knn_topk, window_attn
    from scp_tpu_torch.ops import mlp as mlp_ops
    from scp_tpu_torch.ops import swin_attn
    from scp_tpu_torch.weights import load_into

    # ---- 1. build
    built = _cuda.build_all()
    say(f"phase 1 build: {built['seconds']:.2f} s, cold {built['cold']}, "
        f"cached {built['cached']}")
    resources = {**sm90_resources(_cuda), **knn_resources(_cuda)}

    # ---- 3 (needed by 2). the model
    t0 = time.time()
    model = EHEM(static_knn=True, dtype=torch.bfloat16, device="cuda")
    load_into(model, CKPT)
    torch.cuda.synchronize()
    say(f"phase 3 model: full-width EHEM from {os.path.basename(CKPT)} "
        f"(static KNN on) in {time.time() - t0:.2f} s")

    # the L16 cloud (phase 2 reads its positions, phases 4 and 5 code it)
    t0 = time.time()
    pts = synth_kitti(np.random.default_rng(0), N_POINTS)
    res = preprocess_points(pts, system="spher", qs=kitti_qs(LIDAR_LEVEL))
    slices = split_levels(res.context, angular=True)
    n_nodes = int(slices.occ_stream.shape[0])
    say(f"preprocess: {time.time() - t0:.2f} s, {n_nodes} nodes, {slices.max_level} levels")

    # ---- 2. kernels vs plain
    t0 = time.time()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = kernel_phase(model, gen, slices)
    say(f"phase 2 kernels vs plain: {time.time() - t0:.2f} s")
    for k, r in rows.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        say(f"  {k} {r['name']}: {r['ms']:.4f} ms/launch at {r.get('shape', r.get('tokens'))}, "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"library {lib}")
    d, e = rows["D"], rows["E"]
    say(f"  D shuffled positions: {d['shuffled_ms']:.4f} ms, bound {d['shuffled_bound_ms']:.4f} ms; "
        f"share of the brute-force work scored: sorted {d['groups_visited_share']:.4f}, "
        f"shuffled {d['groups_visited_shuffled_share']:.4f}")
    say(f"  D main-path KNN (ops/knn.knn_indices) {d['main_path_knn_ms']:.4f} ms; at C=192: "
        f"kernel {d['c192_ms']:.4f}, plain {d['c192_plain_ms']:.4f}, main-path KNN "
        f"{d['c192_main_path_knn_ms']:.4f}, bound {d['c192_bound_ms']:.4f} ms")
    say(f"  E at {e['bn240_shape']}: kernel {e['bn240_ms']:.4f}, plain {e['bn240_plain_ms']:.4f}, "
        f"SDPA {e['bn240_library_ms']:.4f}, bound {e['bn240_bound_ms']:.4f} ms")
    b = rows["B"]
    say(f"  B's attention core at B's layout: kernel {b['core_ms']:.4f}, plain "
        f"{b['core_plain_ms']:.4f}, SDPA {b['core_library_ms']:.4f}, bound "
        f"{b['core_bound_ms']:.4f} ms")
    for k in ("A", "B", "C", "E"):
        r = rows[k]
        say(f"  {k} in f32: {r['f32_ms']:.4f} ms/launch, plain {r['f32_plain_ms']:.4f} ms, "
            f"bound {r['f32_bound_ms']:.4f} ms ({r['f32_bound_by']}), "
            f"max_abs_err {r['f32_max_abs_err']:.3g}")

    # ---- 4. the main path: one encode, one decode
    counted = {"A": mlp_ops.ln_mlp_residual, "B": swin_attn.attn_sublayer_self,
               "C": swin_attn.attn_sublayer_cross, "D": knn_topk.knn_topk,
               "E": window_attn.window_attention}
    p4 = roundtrip(EHEMCodec(model, context_size=8192), slices, counted.values())
    say(f"phase 4 roundtrip: lossless, bpp={p4['bpp']:.4f}, nodes={n_nodes}, "
        f"bytes={p4['bytes']}, encode {p4['encode_s']:.3f} s, decode {p4['decode_s']:.3f} s, "
        f"kernel launches A/B/C/D/E = {p4['launches']}")
    if p4["launches"][3] or p4["launches"][4]:
        raise AssertionError("kernels D and E launched with their switches off")
    for k in ("A", "B", "C"):  # bf16 at C = 256: every launch on the Hopper kernels
        if counted[k].arms["sm90"] < p4["launches"][list(counted).index(k)]:
            raise AssertionError(f"kernel {k} left the Hopper GEMM arm: {counted[k].arms}")
    say(f"  GEMM arms of phase 4 (A/B/C): {[counted[k].arms for k in 'ABC']}")
    if abs(p4["bpp"] - MAIN_PATH_BPP) > BPP_RTOL * MAIN_PATH_BPP:
        raise AssertionError(f"phase 4 bpp {p4['bpp']} is not within {BPP_RTOL} of "
                             f"{MAIN_PATH_BPP}")

    # ---- 5. the fused-kernel configuration (pallas_knn, pallas_attn)
    t0 = time.time()
    model5 = EHEM(static_knn=True, pallas_knn=True, pallas_attn=True, dtype=torch.bfloat16,
                  device="cuda")
    load_into(model5, CKPT)
    codec5 = EHEMCodec(model5, context_size=8192)
    say(f"phase 5 model: {time.time() - t0:.2f} s, stamp {codec5.coding_params()}")
    p5 = roundtrip(codec5, slices, counted.values())
    say(f"phase 5 roundtrip: lossless, bpp={p5['bpp']:.4f}, bytes={p5['bytes']}, "
        f"encode {p5['encode_s']:.3f} s, decode {p5['decode_s']:.3f} s, "
        f"kernel launches A/B/C/D/E = {p5['launches']}")
    if abs(p5["bpp"] - p4["bpp"]) > BPP_RTOL * p4["bpp"]:
        raise AssertionError(f"phase 5 bpp {p5['bpp']} is not within {BPP_RTOL} of phase 4's")

    # ---- 6. an f32 model with pallas_attn on: A, B, C and E in f32
    t0 = time.time()
    model6 = EHEM(static_knn=True, pallas_attn=True, dtype=torch.float32, device="cuda")
    load_into(model6, CKPT)
    codec6 = EHEMCodec(model6, context_size=8192)
    say(f"phase 6 model: {time.time() - t0:.2f} s, stamp {codec6.coding_params()}")
    p6 = roundtrip(codec6, slices, counted.values())
    say(f"phase 6 roundtrip (f32): lossless, bpp={p6['bpp']:.4f}, bytes={p6['bytes']}, "
        f"encode {p6['encode_s']:.3f} s, decode {p6['decode_s']:.3f} s, "
        f"kernel launches A/B/C/D/E = {p6['launches']}")
    if abs(p6["bpp"] - F32_PLAIN_BPP) > BPP_RTOL * F32_PLAIN_BPP:
        raise AssertionError(f"phase 6 bpp {p6['bpp']} is not within {BPP_RTOL} of the f32 "
                             f"plain model's {F32_PLAIN_BPP}")

    # A, B, C count from phase 4 (the default path), D and E from phase 5;
    # A, B, C and E in f32 from phase 6
    for k, phase, key in (("A", p4, "launches"), ("B", p4, "launches"), ("C", p4, "launches"),
                          ("D", p5, "launches"), ("E", p5, "launches"),
                          ("A", p6, "f32_launches"), ("B", p6, "f32_launches"),
                          ("C", p6, "f32_launches"), ("E", p6, "f32_launches")):
        n = phase["launches"][list(counted).index(k)]
        if n == 0:
            raise AssertionError(f"kernel {k} ({rows[k]['name']}) never launched on its path")
        rows[k][key] = n
    say(f"total wall {time.time() - t_start:.1f} s")

    for k, prefixes in (("A", ("mlp_sm90<",)), ("B", ("gemm_sm90<",)), ("C", ("gemm_sm90<",)),
                        ("D", ("knn_topk_pruned<", "knn_topk_boxes<"))):
        rows[k]["ptxas"] = {k2: v for k2, v in resources.items() if k2.startswith(prefixes)}
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    table = [{**{k: r[k] for k in keys}, **{k: v for k, v in r.items() if k not in keys}}
             for r in rows.values()]
    say(json.dumps({"kernels": table}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
