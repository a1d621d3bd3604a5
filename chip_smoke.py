"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printed as it ends (any failure exits non-zero):
  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build of the hand-written kernels (one nvcc per source, in parallel);
  2. kernels A (MLP sublayer), B (self attention sublayer) and C (cross
     attention sublayer) against their plain PyTorch versions on the card,
     at the main path's widths (C=256, W=512, 4 heads, F=1024) and at the
     token counts of the L16 cloud's largest level, with the EHEM
     checkpoint's own block weights; times of kernel and plain version;
  3. the full-width EHEM from checkpoints/ehem_synth_f16_sknn.npz (static
     KNN on), loaded through scp_tpu_torch.weights;
  4. one encode and one decode of the 120,000-point synthetic KITTI-like
     cloud at lidar level 16 (seed 0), with the lossless check; the kernel
     launch counts of that run show the path went through the kernels.

The second-to-last line is the JSON kernel table; the last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX or scp_tpu.
"""

from __future__ import annotations

import json
import math
import os
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
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
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


def check_close(name, got, want):
    err = (got.float() - want.float()).abs()
    bound = TOL + TOL * want.float().abs()
    max_err = float(err.max())
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    bad = int((err > bound).sum())
    say(f"  {name}: max_abs_err={max_err:.6g} (tolerance atol=rtol={TOL}), "
        f"elements over tolerance: {bad}")
    if bad:
        raise AssertionError(f"{name}: {bad} elements over tolerance")
    return max_err


def bound_ms(n_bytes: float, flops: float):
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(model, gen):
    """Phase 2: each kernel against its plain version; returns table rows."""
    from scp_tpu_torch.models.swin1d import _mask_tensor
    from scp_tpu_torch.ops import mlp as mlp_ops
    from scp_tpu_torch.ops import swin_attn

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
    got = mlp_ops.ln_mlp_residual(*args)
    torch.cuda.synchronize()
    err = check_close("A ln_mlp_residual (gelu)", got, mlp_ops.ln_mlp_residual_plain(*args))
    ms = cuda_time_ms(lambda: mlp_ops.ln_mlp_residual(*args), 10)
    plain = cuda_time_ms(lambda: mlp_ops.ln_mlp_residual_plain(*args), 3)
    nb = 2 * m_self * c * 2 + 2 * c * f * 2 + 4 * (3 * c + f)
    b, by = bound_ms(nb, 2 * 2 * m_self * c * f)
    rows["A"] = dict(
        name="ln_mlp_residual", route="cuda", source="scp_tpu_torch/ops/csrc/mlp.cu",
        replaces="scp_tpu/ops/pallas_mlp.py:96", max_abs_err=err, ms=ms,
        plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None,
        tokens=m_self,
    )

    # ---- B: self attention sublayer, unshifted (block 0) and shifted (block 1)
    errs, ms_list, plain_list = [], [], []
    for bi, shift in ((0, 0), (1, w // 2)):
        blk = getattr(model.swin_self.stage_0, f"block_{bi}")
        at = blk.attn
        mask = _mask_tensor(width, w, shift, dev)
        xw = rand(m_self // w, w, c)
        args = (xw, blk.norm1.weight, blk.norm1.bias, at.qkv.weight, at.qkv.bias,
                at.rel_bias(), mask, at.proj.weight, at.proj.bias, h, 1e-5)
        got = swin_attn.attn_sublayer_self(*args)
        torch.cuda.synchronize()
        errs.append(check_close(f"B attn_sublayer_self (shift {shift}, {mask.shape[0]} masks)",
                                got, swin_attn.attn_sublayer_self_plain(*args)))
        ms_list.append(cuda_time_ms(lambda: swin_attn.attn_sublayer_self(*args), 10))
        plain_list.append(cuda_time_ms(lambda: swin_attn.attn_sublayer_self_plain(*args), 2))
    n_win = m_self // w
    flops = 2 * m_self * c * 3 * c + 4 * n_win * w * w * c + 2 * m_self * c * c
    nb = 2 * m_self * c * 2 + 4 * c * c * 2 + h * w * w * 4 + mask.numel() * 4
    b, by = bound_ms(nb, flops)
    rows["B"] = dict(
        name="attn_sublayer_self", route="cuda", source="scp_tpu_torch/ops/csrc/swin_attn.cu",
        replaces="scp_tpu/ops/pallas_swin.py:63", max_abs_err=max(errs), ms=ms_list[1],
        plain_ms=plain_list[1], bound_ms=b, bound_by=by, library_ms=None,
        tokens=m_self, ms_unshifted=ms_list[0],
    )

    # ---- C: cross attention sublayer, phase-2 stage 0 block 1 (shifted)
    blk = model.swin_cross.stage_0.block_1
    at = blk.attn
    mask = _mask_tensor(width // 2, w, w // 2, dev)
    xw, qs = rand(m_cross // w, w, c), rand(m_cross // w, w, c)
    args = (xw, qs, blk.norm1.weight, blk.norm1.bias, at.query.weight, at.query.bias,
            at.kv.weight, at.kv.bias, at.rel_bias(), mask, at.proj.weight, at.proj.bias,
            h, 1e-5)
    got = swin_attn.attn_sublayer_cross(*args)
    torch.cuda.synchronize()
    err = check_close(f"C attn_sublayer_cross (shift {w // 2}, {mask.shape[0]} masks)",
                      got, swin_attn.attn_sublayer_cross_plain(*args))
    ms = cuda_time_ms(lambda: swin_attn.attn_sublayer_cross(*args), 10)
    plain = cuda_time_ms(lambda: swin_attn.attn_sublayer_cross_plain(*args), 2)
    n_win = m_cross // w
    flops = 2 * m_cross * c * 4 * c + 4 * n_win * w * w * c
    nb = 3 * m_cross * c * 2 + 4 * c * c * 2 + h * w * w * 4 + mask.numel() * 4
    b, by = bound_ms(nb, flops)
    rows["C"] = dict(
        name="attn_sublayer_cross", route="cuda", source="scp_tpu_torch/ops/csrc/swin_attn.cu",
        replaces="scp_tpu/ops/pallas_swin.py:96", max_abs_err=err, ms=ms,
        plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None, tokens=m_cross,
    )
    return rows


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
    from scp_tpu_torch.ops import _cuda
    from scp_tpu_torch.ops import mlp as mlp_ops
    from scp_tpu_torch.ops import swin_attn
    from scp_tpu_torch.weights import load_into

    # ---- 1. build
    built = _cuda.build_all()
    say(f"phase 1 build: {built['seconds']:.2f} s, cold {built['cold']}, "
        f"cached {built['cached']}")

    # ---- 3 (needed by 2). the model
    t0 = time.time()
    model = EHEM(static_knn=True, dtype=torch.bfloat16, device="cuda")
    load_into(model, CKPT)
    torch.cuda.synchronize()
    say(f"phase 3 model: full-width EHEM from {os.path.basename(CKPT)} "
        f"(static KNN on) in {time.time() - t0:.2f} s")

    # ---- 2. kernels vs plain
    t0 = time.time()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = kernel_phase(model, gen)
    say(f"phase 2 kernels vs plain: {time.time() - t0:.2f} s")
    for k, r in rows.items():
        say(f"  {k} {r['name']}: {r['ms']:.4f} ms/launch at {r['tokens']} tokens, "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")

    # ---- 4. the main path: one encode, one decode
    t0 = time.time()
    pts = synth_kitti(np.random.default_rng(0), N_POINTS)
    res = preprocess_points(pts, system="spher", qs=kitti_qs(LIDAR_LEVEL))
    slices = split_levels(res.context, angular=True)
    n_nodes = int(slices.occ_stream.shape[0])
    say(f"phase 4 preprocess: {time.time() - t0:.2f} s, {n_nodes} nodes, "
        f"{slices.max_level} levels")
    codec = EHEMCodec(model, context_size=8192)
    counted = (mlp_ops.ln_mlp_residual, swin_attn.attn_sublayer_self,
               swin_attn.attn_sublayer_cross)
    for fn in counted:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    stream, bits, _ = codec.encode_to_stream(slices)
    torch.cuda.synchronize()
    t_enc = time.time() - t0
    t0 = time.time()
    dec = codec.new_stream_decoder(stream)
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
    say(f"phase 4 roundtrip: lossless, bpp={bpp:.4f}, nodes={n_nodes}, "
        f"bytes={len(stream)}, encode {t_enc:.3f} s, decode {t_dec:.3f} s, "
        f"kernel launches A/B/C = {launches}")
    for (k, r), n in zip(rows.items(), launches):
        if n == 0:
            raise AssertionError(f"kernel {k} ({r['name']}) never launched on the main path")
        r["launches"] = n
    say(f"total wall {time.time() - t_start:.1f} s")

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
