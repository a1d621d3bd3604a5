"""Training CLI of the port (the twin of scp_tpu/cli/train.py).

    python -m scp_tpu_torch.cli.train --config-name train_kitti.yaml \
        'data.root=data/kitti/spher/*.npy'

Hydra-style dotted overrides are positional arguments.  The config names
the model: OctAttention (train_obj.yaml, the default, and
train_kitti.yaml) or EHEM (train_*_ehem.yaml).  One device: the override
`device=cpu` runs the plain PyTorch path; the default is the card.
The EHEM switches scp_tpu reads from the environment are flags here; on
an OctAttention config each of them is build_model's ValueError, which
names the switch the flag sets.
"""

from __future__ import annotations

import argparse
import datetime
import os


def main(argv=None):
    """Train the config's model; returns the Trainer after its last step."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config-name", default="train_obj.yaml")
    ap.add_argument("--config-dir", default="configs")
    ap.add_argument("--run-dir", default=None)
    ap.add_argument("--static-knn", action="store_true",
                    help="reuse the position graph in every EdgeConv (SCP_STATIC_KNN)")
    ap.add_argument("--pallas-knn", action="store_true",
                    help="kernel D for graphs of N >= 2048 rows (SCP_PALLAS_KNN)")
    ap.add_argument("--pallas-attn", action="store_true",
                    help="kernel E in the padded Swin stages (SCP_PALLAS_ATTN)")
    ap.add_argument("--explicit-edgeconv", dest="fused_edgeconv", action="store_false",
                    help="the explicit train EdgeConv (SCP_FUSED_EDGECONV=0)")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_intermixed_args(argv)

    from scp_tpu_torch.config import load_config
    from scp_tpu_torch.train.data import ShardDataset, build_dataset
    from scp_tpu_torch.train.trainer import Trainer

    cfg = load_config(args.config_name, args.config_dir, args.overrides)
    # only the switches the user set: the model's defaults are the others
    defaults = dict(static_knn=False, pallas_knn=False, pallas_attn=False, fused_edgeconv=True)
    switches = {k: getattr(args, k) for k, v in defaults.items() if getattr(args, k) != v}
    print(cfg.to_plain())
    seed = int(cfg.get("seed", cfg.train.get("seed", 42)))
    cfg.seed = seed

    dataset = build_dataset(cfg)
    trainer = Trainer(cfg, steps_per_epoch=dataset.steps_per_epoch(), device=cfg.get("device"),
                      **switches)

    # validation batches (bits/node curve in metrics.jsonl): held out when
    # cfg.data.val_root points at disjoint shards; without it, a
    # differently-seeded pass over the training shards
    val_batches = None
    n_val = int(cfg.data.get("val_batches", 4))
    if n_val:
        val_ds = ShardDataset(
            root=str(cfg.data.get("val_root") or cfg.data.root),
            context_size=cfg.data.context_size,
            batch_size=dataset.batch_size,
            mode=dataset.mode,
            vari_data_len=False,
            seed=seed + 1,
        )
        gen = val_ds.batches()
        val_batches = [next(gen) for _ in range(n_val)]

    if args.run_dir:
        run_dir = args.run_dir
    else:
        now = datetime.datetime.now()
        run_dir = os.path.join(cfg.train.get("run_root", "outputs"), str(cfg.train.type),
                               now.strftime("%Y-%m-%d"), now.strftime("%H-%M-%S"))
    print("saving in", run_dir)
    print("device:", trainer.device)
    trainer.fit(dataset, run_dir, val_batches=val_batches)
    return trainer


if __name__ == "__main__":
    main()
