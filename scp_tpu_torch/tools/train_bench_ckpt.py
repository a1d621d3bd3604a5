"""Train a bench checkpoint on synthetic KITTI-like LiDAR, on the card
(the twin of scp_tpu/tools/train_bench_ckpt.py, the recipe behind
`checkpoints/ehem_synth_f16*.npz`).

    python -m scp_tpu_torch.tools.train_bench_ckpt \
        --steps 4000 --batch 8 --init_npz checkpoints/ehem_synth_f16_sknn.npz \
        --static_knn --out outputs/ehem_port.npz

Clouds come from the bench generator with seeds 1000+ (training) and 5000+
(validation), disjoint from the bench cloud's seed 0, and are
preprocessed by the port's core/preprocess.py into (N, 4, 6) shards
(spherical, L16).  The full-width EHEM (configs/train_kitti_ehem.yaml,
context 8192) trains in bf16 without remat, Adam + StepLR, with
vari_data_len on; validation bits/node on two held-out batches go to
metrics.jsonl every 250 steps.  The npz it writes is scp_tpu's format.
chip_smoke.py phase 7 reuses `gen_shards`, `recipe_config` and the
datasets built here.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np


def synth_kitti(rng, n):
    """Same ring-structured LiDAR generator as bench.py."""
    beams = 64
    el = np.deg2rad(np.linspace(-24.8, 2.0, beams))[rng.integers(0, beams, n)]
    az = rng.uniform(0, 2 * np.pi, n)
    r = np.clip(rng.gamma(3.0, 8.0, n) + 2.0, 2.0, 120.0)
    x = r * np.cos(el) * np.cos(az)
    y = r * np.cos(el) * np.sin(az)
    z = r * np.sin(el)
    return np.stack([x, y, z], 1)


def gen_shards(out_dir: str, n_clouds: int, n_points: int, lidar_level: int,
               seed_base: int = 1000, system: str = "spher"):
    """Seeds seed_base.. are disjoint from bench.py's held-out seed 0 and
    from the validation clouds (seed_base 5000).  The directory is stamped
    with the recipe (_gen_meta.json); a mismatch refuses to reuse it."""
    from scp_tpu_torch.core.preprocess import kitti_qs, preprocess_points

    os.makedirs(out_dir, exist_ok=True)
    meta_path = os.path.join(out_dir, "_gen_meta.json")
    meta = {"system": system, "lidar_level": lidar_level, "points": n_points}
    if os.path.exists(meta_path):
        with open(meta_path) as fh:
            found = json.load(fh)
        if found != meta:
            raise SystemExit(
                f"{out_dir} holds shards generated with {found}, requested "
                f"{meta}; point --shard_dir somewhere else"
            )
    else:
        if glob.glob(os.path.join(out_dir, "cloud*.npy")):
            raise SystemExit(
                f"{out_dir} has shards but no _gen_meta.json (pre-stamp "
                f"layout); point --shard_dir somewhere else or delete them"
            )
        with open(meta_path, "w") as fh:
            json.dump(meta, fh)
    for i in range(n_clouds):
        if glob.glob(os.path.join(out_dir, f"cloud{i:03d}_*.npy")):
            continue
        rng = np.random.default_rng(seed_base + i)
        pts = synth_kitti(rng, n_points)
        res = preprocess_points(pts, system=system, qs=kitti_qs(lidar_level))
        n = res.context.shape[0]
        # write-to-tmp + rename: a killed run never leaves a truncated shard
        final = os.path.join(out_dir, f"cloud{i:03d}_{n}.npy")
        tmp = final + ".tmp"
        with open(tmp, "wb") as fh:
            np.save(fh, res.context)
        os.replace(tmp, final)
        print(f"shard {i + 1}/{n_clouds}: {n} nodes", flush=True)


def recipe_config(shard_dir: str, batch: int, context: int, config_dir: str = "configs",
                  small: bool = False):
    """configs/train_kitti_ehem.yaml with the recipe's settings: bf16,
    remat off, vari_data_len on, logging every 25 steps, validation every
    250."""
    from scp_tpu_torch.config import Config, load_config

    cfg = load_config("train_kitti_ehem.yaml", config_dir=config_dir)
    if small:
        cfg.model.swin = Config.wrap(dict(embed_dim=64, self_depths=[2, 2], cross_depths=[1],
                                          num_heads=2, window_size=16, mlp_ratio=2.0))
    cfg.data.root = os.path.join(shard_dir, "*.npy")
    cfg.data.batch_size = batch
    cfg.model.context_size = context
    cfg.data.context_size = context
    cfg.data.vari_data_len = True
    cfg.bf16 = True
    cfg.remat = False
    cfg.train.log_every = 25
    cfg.train.val_every = 250
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--context", type=int, default=8192)
    ap.add_argument("--clouds", type=int, default=24)
    ap.add_argument("--points", type=int, default=120_000)
    ap.add_argument("--lidar_level", type=int, default=16)
    ap.add_argument("--system", default="spher", choices=["spher", "cylin", "cart"])
    ap.add_argument("--shard_dir", default="data/synth_kitti")
    ap.add_argument("--run_dir", default="outputs/bench_ckpt_port")
    ap.add_argument("--out", default="outputs/ehem_port.npz")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--init_npz", default="",
                    help="warm-start params from a .npz bench checkpoint (fresh optimizer)")
    ap.add_argument("--lr_scale", type=float, default=1.0)
    ap.add_argument("--lr_step", type=int, default=0,
                    help="override StepLR step_size in epochs")
    ap.add_argument("--lr_gamma", type=float, default=0.0)
    ap.add_argument("--static_knn", action="store_true",
                    help="reuse the position graph in every EdgeConv (the sknn checkpoint)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--small", action="store_true",
                    help="tiny model + shapes (CPU smoke test of the recipe)")
    args = ap.parse_args(argv)

    from scp_tpu_torch.train import checkpoints
    from scp_tpu_torch.train.data import ShardDataset
    from scp_tpu_torch.train.trainer import Trainer

    print("generating shards...", flush=True)
    gen_shards(args.shard_dir, args.clouds, args.points, args.lidar_level, system=args.system)
    cfg = recipe_config(args.shard_dir, args.batch, args.context, small=args.small)
    if args.lr_step:
        cfg.train.lr_scheduler.step_size = args.lr_step
    if args.lr_gamma:
        cfg.train.lr_scheduler.gamma = args.lr_gamma
    if args.lr_scale != 1.0:
        cfg.train.lr = float(cfg.train.lr) * args.lr_scale
    if args.init_npz:
        cfg.train.load_pretrain = args.init_npz

    dataset = ShardDataset(root=cfg.data.root, context_size=args.context,
                           batch_size=args.batch, mode="ehem", vari_data_len=True, seed=42)
    steps_per_epoch = dataset.steps_per_epoch()
    epochs = max(1, -(-args.steps // steps_per_epoch))
    cfg.train.epoch = epochs
    print(f"{len(dataset.files)} shards, {dataset.total_nodes} nodes, "
          f"{steps_per_epoch} steps/epoch x {epochs} epochs", flush=True)

    # held-out validation: disjoint clouds (seed base 5000)
    val_dir = args.shard_dir.rstrip("/") + "_val"
    gen_shards(val_dir, 2, args.points, args.lidar_level, seed_base=5000, system=args.system)
    val_ds = ShardDataset(root=os.path.join(val_dir, "*.npy"), context_size=args.context,
                          batch_size=args.batch, mode="ehem", vari_data_len=False, seed=7)
    gen = val_ds.batches()
    val_batches = [next(gen) for _ in range(2)]

    trainer = Trainer(cfg, steps_per_epoch=steps_per_epoch, device=args.device,
                      static_knn=args.static_knn)
    t0 = time.time()
    trainer.fit(dataset, args.run_dir, epochs=epochs, resume=args.resume,
                val_batches=val_batches)
    print(f"training wall: {time.time() - t0:.0f}s", flush=True)
    print(f"final val: {trainer.evaluate(val_batches):.4f} bits/node", flush=True)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    checkpoints.save_params_npz(args.out, trainer.model)
    print(f"saved {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
