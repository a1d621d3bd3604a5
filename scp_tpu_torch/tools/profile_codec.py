"""Device time, fetches, the host coder and MFU of the codec's phase calls
and of a training step (the twin of scp_tpu/tools/profile_codec.py).

    python -m scp_tpu_torch.tools.profile_codec --what codec --group 8 \\
        [--mode rans|staged|full] [--peak-flops 989e12]
    python -m scp_tpu_torch.tools.profile_codec --what train --batch 8 [--remat]

Runs on the card unless given `--device cpu` and prints one JSON line with
the keys of scp_tpu's two reports (its `backend` is `device` here).

  * codec: one phase-1 call at (group, context) and its phase-2 call, the
    warm median of their CUDA-event times; in the staged and full modes
    the fetches of their CDF rows with their byte counts; the port's host
    coder (`scp_tpu_torch.ac`) on scp_tpu's synthetic rows; the MFU of
    both calls against `--peak-flops` (default: the H100 SXM's dense bf16
    peak).  `--mode` is scp_tpu's SCP_CODEC_MODE.  The model is the main
    path's: checkpoints/ehem_synth_f16_sknn.npz with static KNN (scp_tpu's
    tool reads SCP_STATIC_KNN, off by default, and profiles the dynamic
    graph of ehem_synth_f16.npz).
  * train: the step that tools/profile_train.py times, chip_smoke.py phase
    7's recipe (configs/train_kitti_ehem.yaml at (batch, context), bf16,
    warm from the sknn checkpoint, one fixed batch of 2 synthetic clouds
    written under chiprun_out/ and removed), remat off unless `--remat`:
    the median of 10 timed steps, MFU and tokens/s.

FLOPs are not read from a compiler: the hand-written kernels run through
ctypes, where `torch.utils.flop_counter` cannot see them.  They are the
model's dense products in closed form, counted by each module beside its
forward (`EHEM.phase1_flops`, `phase2_flops`, `forward_flops`): the KNN
scores, the DGCNN projections and MLPs, the Swin q/k/v, attention,
projection, MLP and merge products, and the heads, 2 FLOPs per
multiply-add, at the shapes the plain path runs (padded windows
included).  The tests hold them equal to FlopCounterMode on the plain
path.  A training step counts 3x its forward products (the model-FLOPs
convention: the plain backward's recompute is not counted).  On the CPU
the MFU keys are null: a CPU time against a card's peak is no device
metric.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from scp_tpu_torch.tools.profile_train import CKPT as SKNN_CKPT

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 tensor cores (NVIDIA data sheet)
TRAIN_STEPS = 10  # timed, after profile_train's two warm steps
STEP_CONVENTION = "3 x forward products (model FLOPs; the backward's recompute not counted)"
PHASE_CONVENTION = "forward products of the call, 2 per multiply-add, closed form"


# ---- timing --------------------------------------------------------------------

def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def median_s(fn, device, n: int = 3, warm: int = 1) -> float:
    """Warm median of `n` calls: CUDA-event times on a card, the host clock
    (after a sync) on the CPU."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(n):
        if device.type == "cuda":
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _host_s(fn, device, n: int = 3) -> float:
    """Median host wall of a call that ends on the host (a fetch)."""
    times = []
    for _ in range(n):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _mfu(flops: float, seconds: float, peak: float, device):
    if device.type != "cuda":
        return None  # a CPU time against a card's peak is no device metric
    return 100.0 * flops / seconds / peak


def _device_kind(device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _launches(counted) -> dict:
    return {k: fn.launches for k, fn in counted.items()}


def load_model(ckpt: str, device):
    """The main path's model (static KNN, bf16) with the weights of `ckpt`."""
    from scp_tpu_torch.models.ehem import EHEM
    from scp_tpu_torch.weights import load_into

    if not os.path.exists(ckpt):
        raise FileNotFoundError(ckpt)
    return load_into(EHEM(static_knn=True, dtype=torch.bfloat16, device=device), ckpt)


def step_rates(model, batch, step_s: float, peak: float = PEAK_BF16_FLOPS) -> dict:
    """A training step's products (3x the closed-form forward on the
    batch's (rows, context)), MFU and tokens/s; {} for a model without a
    closed form (OctAttention)."""
    if not hasattr(model, "forward_flops"):
        return {}
    rows, context = batch["data"].shape[:2]
    fwd = model.forward_flops(rows, context)
    return {"forward_flops": fwd, "step_flops": 3 * fwd,
            "mfu_pct": _mfu(3 * fwd, step_s, peak, model.device),
            "tokens_per_s": rows * context / step_s, "flops_convention": STEP_CONVENTION}


# ---- the two reports -------------------------------------------------------------

def profile_codec(args, model=None) -> dict:
    """`--what codec`; `model` overrides the checkpoint's (tests)."""
    from scp_tpu_torch import ac, resolve_device
    from scp_tpu_torch.codec.ehem_codec import EHEMCodec
    from scp_tpu_torch.codec.staged import intervals, staged_cdfs_np
    from scp_tpu_torch.tools.profile_train import counted_kernels, reset_counts

    dev = resolve_device(args.device)
    model = load_model(SKNN_CKPT, dev) if model is None else model
    codec = EHEMCodec(model, context_size=args.context, mode=args.mode, group_size=args.group)
    g, csz = args.group, args.context
    counted = counted_kernels()
    f1, f2 = model.phase1_flops(g, csz), model.phase2_flops(g, csz)

    with torch.no_grad():
        if codec.mode == "rans":
            # the device-resident wavefront's buffer-fed calls
            data_buf, pos_buf = codec._root_bufs(g * csz)

            def p1():
                return codec._phase1(codec.model, data_buf, pos_buf, 0, 2**31 - 1, 0,
                                     np.float32(1.0), g, csz)

            occ = torch.zeros((g, (csz + 1) // 2), dtype=torch.uint8, device=dev)
        else:
            d = np.zeros((g, csz, 4, 3), np.uint8)
            d[:, :, :, 2] = 255
            db, pb = codec._to_dev(d), codec._to_dev(np.zeros((g, csz, 3), np.uint16))
            occ = codec._to_dev(np.full((g, (csz + 1) // 2), 255, np.uint8))

            def p1():
                return codec._phase1_call(db, pb)

        outs, feat1, feat2 = p1()

        def p2():
            if codec.mode == "rans":
                return codec._phase2(codec.model, feat1, feat2, occ)
            return codec._phase2_call(feat1, feat2, occ)

        p2()
        reset_counts(counted.values())
        t_p1 = median_s(p1, dev)
        t_p2 = median_s(p2, dev)
        launches = _launches(counted)

        # transfer: re-fetch rows already computed (the fetch alone)
        if codec.mode == "rans":
            # decode fetches one byte per node per parity; encode only the
            # compressed blocks: no CDF row leaves the device
            t_hi, hi_bytes, t_iv, iv_bytes = 0.0, g * csz, 0.0, 0
        elif codec.mode == "staged":
            hi1, cond1 = outs
            iv = intervals(hi1, cond1, occ)
            t_hi = _host_s(lambda: codec._host_u16(hi1), dev)
            t_iv = _host_s(lambda: codec._host_u16(iv), dev)
            hi_bytes, iv_bytes = codec._host_u16(hi1).nbytes, codec._host_u16(iv).nbytes
        else:
            (cdf1,) = outs
            t_hi = _host_s(lambda: codec._host_u16(cdf1), dev)
            hi_bytes, t_iv, iv_bytes = codec._host_u16(cdf1).nbytes, 0.0, 0

    # the host coder on scp_tpu's synthetic rows
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 2, (g * csz // 2, 255)).astype(np.float32)
    hi_cdf, cond_cdf = staged_cdfs_np(logits)
    syms = rng.integers(0, 255, g * csz // 2)
    hi, lo = syms >> 4, syms & 15
    enc = ac.StreamingEncoder()
    t0 = time.perf_counter()
    enc.append_quantized(hi_cdf, hi.astype(np.int16))
    rows = cond_cdf[np.arange(len(syms)), hi]
    enc.append_quantized(rows, lo.astype(np.int16))
    stream, _ = enc.finish()
    t_ac_enc = time.perf_counter() - t0
    dec = ac.ArithmeticDecoder(stream, 2 * len(syms))
    t0 = time.perf_counter()
    dec.decode_batch_quantized(hi_cdf)
    dec.decode_batch_quantized(rows)
    t_ac_dec = time.perf_counter() - t0

    nodes = g * csz
    return {
        "what": "codec phase profile",
        "device": dev.type,
        "device_kind": _device_kind(dev),
        "mode": codec.mode,
        "group": g,
        "nodes_per_call": nodes,
        "phase1_flops": f1,
        "phase1_s": t_p1,
        "phase1_mfu_pct": _mfu(f1, t_p1, args.peak_flops, dev),
        "phase2_flops": f2,
        "phase2_s": t_p2,
        "phase2_mfu_pct": _mfu(f2, t_p2, args.peak_flops, dev),
        "fetch_hi_cdf_s": t_hi,
        "fetch_hi_cdf_bytes": int(hi_bytes),
        "fetch_iv_s": t_iv,
        "fetch_iv_bytes": int(iv_bytes),
        "ac_enc_s_per_mnode": t_ac_enc / nodes * 2e6,
        "ac_dec_s_per_mnode": t_ac_dec / nodes * 2e6,
        "peak_flops": args.peak_flops,
        "flops_convention": PHASE_CONVENTION,
        "launches": launches,
    }


def profile_train(args, work: str | None = None, small: bool = False) -> dict:
    """`--what train`: profile_train's timed steps of its default recipe,
    its shards written under `work` (chiprun_out/profile_codec) and
    removed; `small`: the recipe's narrow model on 3,000-point clouds at
    level 10 (the CPU tests)."""
    import shutil

    from scp_tpu_torch import resolve_device
    from scp_tpu_torch.tools import profile_train as pt
    from scp_tpu_torch.tools.train_bench_ckpt import gen_shards
    from scp_tpu_torch.train.trainer import Trainer

    dev = resolve_device(args.device)
    work = work or os.path.join("chiprun_out", "profile_codec")
    shutil.rmtree(work, ignore_errors=True)
    try:
        gen_shards(work, 2, *((3000, 10) if small else (pt.N_POINTS, pt.LIDAR_LEVEL)),
                   seed_base=1000)
        cfg, fixed = pt.recipe_batch(work, args.batch, args.context, small=small)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cfg.remat = bool(args.remat)
    trainer = Trainer(cfg, steps_per_epoch=25, device=dev, static_knn=True)
    trainer.init_state()
    counted = pt.counted_kernels()
    pt.reset_counts(counted.values())
    timed = pt.timed_steps(trainer, fixed, TRAIN_STEPS)
    rows, context = fixed["data"].shape[:2]
    return {
        "what": "train step profile",
        "device": dev.type,
        "device_kind": _device_kind(dev),
        "batch": int(rows),
        "context": int(context),
        "remat": bool(args.remat),
        "steps": TRAIN_STEPS,
        "step_s": timed["median_s_per_step"],
        **step_rates(trainer.model, fixed, timed["median_s_per_step"], args.peak_flops),
        "peak_memory_gb": timed["peak_memory_gb"],
        "peak_flops": args.peak_flops,
        "launches": _launches(counted),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--what", choices=["codec", "train"], required=True)
    ap.add_argument("--group", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--context", type=int, default=8192)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--mode", choices=["rans", "staged", "full"], default="rans",
                    help="the codec's coding mode (scp_tpu's SCP_CODEC_MODE)")
    ap.add_argument("--peak-flops", type=float, default=PEAK_BF16_FLOPS,
                    help="peak FLOP/s for MFU (default: H100 SXM dense bf16)")
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    out = profile_codec(args) if args.what == "codec" else profile_train(args)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
