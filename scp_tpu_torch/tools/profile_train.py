"""Where the time of one full-width training step goes, on the card.

    python -m scp_tpu_torch.tools.profile_train [--config-name NAME [override ...]] \
        [--steps 10] [--out chiprun_out/profile_train.json]

Run from the root of the repository.  It profiles one fixed batch drawn
from the port's synthetic shards (2 clouds of 120,000 points at lidar
level 16, seeds 1000-1001, written under chiprun_out/ and removed at the
end):

  * with no --config-name: the EHEM recipe of chip_smoke.py phase 7
    (batch 8 x context 8192, bf16, Adam + StepLR, warm from
    checkpoints/ehem_synth_f16_sknn.npz, static KNN on), with remat off
    and then on;
  * with --config-name: the model, batch and context that config names
    (train_kitti.yaml and train_obj.yaml: OctAttention at 16 x 1024),
    with its dotted overrides (`train.dropout=0.1`) applied, as
    cli.train builds it with no flags.  `data.root` defaults to the
    synthetic shards; the model warm-starts only from the config's own
    `train.load_pretrain`
    (`train.load_pretrain=checkpoints/octattn_synth_l12_v2.npz`).

Each run reports the median wall of `--steps` timed steps, the peak
memory, the forward / backward / update split, for EHEM the step's MFU
and tokens/s (`profile_codec.step_rates`), one step under
torch.profiler with each kernel's forward and plain backward in named
ranges (their device time summed over the step), and the device kernel
time by name with its idle share against the timed wall.  Prints a
summary and writes it as JSON to --out.  chip_smoke.py phases 7 and 10 use
`profiled_step`, `timed_steps`, `kernel_profile` and `reset_counts` from
here; `profile_codec --what train` times the default recipe's step with
`recipe_batch` and `timed_steps`.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import time

import numpy as np
import torch

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                    "checkpoints", "ehem_synth_f16_sknn.npz")
N_POINTS, LIDAR_LEVEL = 120_000, 16  # the bench cloud's size and level


def counted_kernels():
    """The kernel wrappers, by letter, whose `launches` count their launches."""
    from scp_tpu_torch.ops import knn_topk, swin_attn, window_attn
    from scp_tpu_torch.ops import mlp as mlp_ops

    return {"A": mlp_ops.ln_mlp_residual, "B": swin_attn.attn_sublayer_self,
            "C": swin_attn.attn_sublayer_cross, "D": knn_topk.knn_topk,
            "E": window_attn.window_attention}


def reset_counts(counted):
    for fn in counted:
        fn.launches = 0
        for arm in getattr(fn, "arms", {}):
            fn.arms[arm] = 0


def seam_functions():
    """The autograd Functions of A, B, C and E: the kernel forward, the
    plain backward."""
    from scp_tpu_torch.ops import mlp as mlp_ops
    from scp_tpu_torch.ops import swin_attn, window_attn

    return {"A": mlp_ops.LnMlpResidual, "B": swin_attn.AttnSublayerSelf,
            "C": swin_attn.AttnSublayerCross, "E": window_attn.WindowAttention}


class ranged_seams:
    """Wraps each seam Function's forward and backward (and D's launcher)
    in a torch.profiler range named "<kernel>.forward" / ".backward"."""

    def __enter__(self):
        from torch.profiler import record_function

        from scp_tpu_torch.ops import knn_topk

        self.saved = []

        def ranged(fn, label):
            def wrapped(*a, **k):
                with record_function(label):
                    return fn(*a, **k)
            return wrapped

        for tag, cls in seam_functions().items():
            for meth in ("forward", "backward"):
                raw = cls.__dict__[meth]
                self.saved.append((cls, meth, raw))
                setattr(cls, meth, staticmethod(ranged(raw.__func__, f"{tag}.{meth}")))
        fn = knn_topk.knn_topk
        self.saved.append((knn_topk, "knn_topk", fn))
        wrapped = ranged(fn, "D.forward")
        wrapped.launches, wrapped.arms = fn.launches, fn.arms  # the arms count in place
        knn_topk.knn_topk = wrapped
        return self

    def __exit__(self, *exc):
        from scp_tpu_torch.ops import knn_topk

        for owner, name, raw in reversed(self.saved):
            if owner is knn_topk:
                raw.launches = knn_topk.knn_topk.launches
            setattr(owner, name, raw)
        return False


def profiled_step(step):
    """One call of `step` under torch.profiler with the seams ranged: per
    kernel and part, "<part>_span_ms", the ranges' device spans (gaps
    included), and "<part>_kernels_ms", the device time of the kernels
    that PyTorch ops launched inside them, each summed over the step.  A
    hand-written kernel goes through ctypes: the profiler sees it on the
    device but under no host op.  So "forward_ms" is the forward's span
    (its one launch and the small ops around it) and "backward_ms" the
    backward's kernels (the plain recompute is PyTorch ops)."""
    from torch.profiler import ProfilerActivity, profile

    with ranged_seams(), profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        tag, _, part = e.key.partition(".")
        if part not in ("forward", "backward") or tag not in "ABCDE":
            continue
        row = out.setdefault(tag, {})
        if str(getattr(e, "device_type", "")).endswith("CUDA"):  # the range on the device
            dev = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
            row[f"{part}_span_ms"] = dev / 1e3
        else:  # the host range: the device time of the kernels its ops launched
            dev = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
            row[f"{part}_kernels_ms"] = dev / 1e3
            row[f"{part}_count"] = e.count
    for row in out.values():
        row["forward_ms"] = row.get("forward_span_ms")
        row["backward_ms"] = row.get("backward_kernels_ms")
    return out


def timed_steps(trainer, batch, steps: int) -> dict:
    """`steps` train_steps on `batch` after two warm ones: the median and
    every wall (host clock ending in a sync), the peak memory (None on the
    CPU) and the forward / backward / update shares."""
    cuda = trainer.device.type == "cuda"
    for _ in range(2):  # warm: allocator, kernel loads
        trainer.train_step(batch)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    walls, split, losses = [], {}, []
    for _ in range(steps):
        t = time.perf_counter()
        losses.append(float(trainer.train_step(batch, timings=split)))
        walls.append(time.perf_counter() - t)
    total = sum(split.values())
    return {"steps": steps, "median_s_per_step": float(np.median(walls)), "walls_s": walls,
            "losses": losses,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
            "shares": {k: v / total for k, v in split.items()}}


def kernel_profile(step, wall_s: float, top: int = 20) -> dict:
    """One call of `step` under torch.profiler: the device kernel time
    summed and by name (the `top` largest), and the idle share against a
    step's wall `wall_s`."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()

    def dev(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))

    kernels = sorted(((e.key, dev(e) / 1e3, e.count) for e in prof.key_averages()
                      if str(getattr(e, "device_type", "")).endswith("CUDA") and dev(e) > 0),
                     key=lambda r: -r[1])
    device_ms = sum(k[1] for k in kernels)
    return {"device_kernel_ms": device_ms,
            "device_idle_share": max(0.0, 1.0 - device_ms / (1e3 * wall_s)),
            "top_kernels": [{"name": n[:120], "ms": ms, "count": c} for n, ms, c in kernels[:top]]}


def recipe_batch(shards: str, batch: int = 8, context: int = 8192, small: bool = False):
    """chip_smoke.py phase 7's EHEM recipe on the clouds in `shards`: its
    config (warm from CKPT; `small`: the recipe's narrow model, fresh) and
    its first batch."""
    from scp_tpu_torch.tools.train_bench_ckpt import recipe_config
    from scp_tpu_torch.train.data import ShardDataset

    cfg = recipe_config(shards, batch, context, small=small)
    if not small:
        cfg.train.load_pretrain = CKPT
    return cfg, next(ShardDataset(cfg.data.root, context, batch, mode="ehem").batches())


def measure(cfg, fixed, steps: int, counted, remat=None, **switches):
    from scp_tpu_torch.tools.profile_codec import step_rates
    from scp_tpu_torch.train.trainer import Trainer

    if remat is not None:
        cfg.remat = remat
    trainer = Trainer(cfg, steps_per_epoch=25, device="cuda", **switches)
    trainer.init_state()
    timed = timed_steps(trainer, fixed, steps)
    rates = step_rates(trainer.model, fixed, timed["median_s_per_step"])
    reset_counts(counted.values())
    ranges = profiled_step(lambda: trainer.train_step(fixed))
    launches = {k: fn.launches for k, fn in counted.items()}
    prof = kernel_profile(lambda: trainer.train_step(fixed), timed["median_s_per_step"])
    del trainer
    torch.cuda.empty_cache()
    return {"remat": remat, **timed, **rates, "kernel_ranges": ranges,
            "launches_per_step": launches, **prof}


def named_config(config_name: str, overrides, shard_glob: str):
    """The config `config_name` with `overrides` applied (`data.root` set
    to `shard_glob` unless they set it) and the first batch of the dataset
    cli.train would build from it."""
    from scp_tpu_torch.config import load_config
    from scp_tpu_torch.train.data import build_dataset

    cfg = load_config(config_name, "configs", [f"data.root={shard_glob}", *overrides])
    return cfg, next(build_dataset(cfg).batches())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config-name", default=None,
                    help="a training config; without it, chip_smoke.py phase 7's EHEM recipe")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "profile_train.json"))
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_intermixed_args(argv)
    if args.overrides and args.config_name is None:
        ap.error("overrides apply to a --config-name; the default recipe takes none")
    if not torch.cuda.is_available():
        raise SystemExit("profile_train.py measures the card; no CUDA device available")

    from scp_tpu_torch.tools.train_bench_ckpt import gen_shards

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    counted = counted_kernels()
    work = os.path.join("chiprun_out", "profile_train")
    shutil.rmtree(work, ignore_errors=True)
    try:
        shards = os.path.join(work, "shards")
        gen_shards(shards, 2, N_POINTS, LIDAR_LEVEL, seed_base=1000)
        if args.config_name is None:
            cfg, fixed = recipe_batch(shards)
            runs = [measure(cfg, fixed, args.steps, counted, remat=remat, static_knn=True)
                    for remat in (False, True)]
        else:
            cfg, fixed = named_config(args.config_name, args.overrides,
                                      os.path.join(shards, "*.npy"))
            runs = [measure(cfg, fixed, args.steps, counted)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = {"card": card, "config": args.config_name or "recipe", "overrides": args.overrides,
           "model": str(cfg.model.class_name),
           "batch": list(fixed["data"].shape[:2]), "runs": runs}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print(card)
    print(f"{out['model']} ({out['config']} {' '.join(args.overrides)}), batch {out['batch']}")
    for r in runs:
        print(f"remat={r['remat']}: median {r['median_s_per_step']:.4f} s/step over {r['steps']}, "
              f"peak {r['peak_memory_gb']:.2f} GB, shares "
              + ", ".join(f"{k} {v:.3f}" for k, v in r["shares"].items())
              + (f"; MFU {r['mfu_pct']:.3f}%, {r['tokens_per_s']:.1f} tokens/s"
                 if r.get("mfu_pct") is not None else "")
              + f"; device kernels {r['device_kernel_ms']:.1f} ms, idle share "
              f"{r['device_idle_share']:.3f}; launches {r['launches_per_step']}")
        for k, v in sorted(r["kernel_ranges"].items()):
            print(f"  {k}: forward {v.get('forward_ms')} ms x{v.get('forward_count')} (span "
                  f"{v.get('forward_span_ms')}), plain backward {v.get('backward_ms')} ms "
                  f"x{v.get('backward_count')} (span {v.get('backward_span_ms')})")
        for t in r["top_kernels"][:10]:
            print(f"  kernel {t['ms']:9.2f} ms x{t['count']:5d}  {t['name'][:90]}")


if __name__ == "__main__":
    main()
