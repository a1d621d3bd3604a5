"""Training CLI of the port (the twin of scp_tpu/cli/train.py).

    python -m scp_tpu_torch.cli.train --config-name train_kitti.yaml \
        'data.root=data/kitti/spher/*.npy'

Hydra-style dotted overrides are positional arguments.  The config names
the model: OctAttention (train_obj.yaml, the default, and
train_kitti.yaml) or EHEM (train_*_ehem.yaml).  The override
`device=cpu` runs the plain PyTorch path; the default is the card.
The EHEM switches scp_tpu reads from the environment are flags here; on
an OctAttention config each of them is build_model's ValueError, which
names the switch the flag sets.

Data-parallel (train/distributed.py): `cfg.devices` is scp_tpu's, the
number of devices to train on: every visible card by default (one on the
CPU), reduced until it divides the global `data.batch_size`.  With more
than one, the CLI starts one rank per card itself (spawned processes, one
rendezvous), and returns when every rank has exited; a rank that fails
makes it raise.  `device=cpu devices=N` runs N gloo ranks on the CPU.
Under torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK) it runs as
the one rank torchrun made:

    torchrun --nproc-per-node 4 -m scp_tpu_torch.cli.train --config-name ...

and under scp_tpu's multi-host recipe (SCP_COORDINATOR, SCP_NUM_PROCESSES,
SCP_PROCESS_ID: one process per host) it starts one rank per local card,
joined to the other hosts' through the coordinator.  Rank 0 prints and
writes the run dir.
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys


def _parse(argv):
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
    return ap.parse_intermixed_args(argv)


def _launched(env) -> bool:
    """This process is one rank that torchrun (or this CLI) started."""
    from scp_tpu_torch.train.distributed import TORCHRUN_VARS

    return all(v in env for v in TORCHRUN_VARS) or bool(
        env.get("SCP_COORDINATOR") and "LOCAL_RANK" in env)


def local_ranks(cfg, hosts: int = 1) -> int:
    """The ranks this machine runs: cfg.devices (every visible card by
    default, one on the CPU), reduced until hosts x ranks divides the
    global batch, as scp_tpu reduces its mesh."""
    import torch

    dev = torch.device(cfg.get("device") or "cuda")
    avail = torch.cuda.device_count() if dev.type == "cuda" else 1
    n = int(cfg.get("devices") or avail)
    if dev.type == "cuda" and n > avail:
        raise ValueError(f"devices={n}, but {avail} CUDA devices are visible")
    batch = int(cfg.data.batch_size)
    while n > 1 and batch % (n * hosts):
        n -= 1
    return max(n, 1)


def _rank_main(argv):
    """A spawned rank: the training of main() in a process group."""
    main(argv)


def main(argv=None):
    """Train the config's model; returns the Trainer after its last step
    (None in the process that started the ranks)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parse(argv)

    from scp_tpu_torch.config import load_config
    from scp_tpu_torch.train import distributed

    cfg = load_config(args.config_name, args.config_dir, args.overrides)
    env = os.environ
    if not _launched(env):
        hosts = int(env["SCP_NUM_PROCESSES"]) if env.get("SCP_COORDINATOR") else 1
        n = local_ranks(cfg, hosts)
        if n > 1:
            import torch

            threads = max(1, torch.get_num_threads() // n)
            distributed.run_workers(
                _rank_main, n, args=(argv,), backend=distributed.backend_for(
                    cfg.get("device") or "cuda"), threads=threads, timeout_s=None,
                rendezvous=hosts == 1)
            return None
    distributed.maybe_initialize(env, device=cfg.get("device") or "cuda")
    return _train(args, cfg)


def _train(args, cfg):
    from scp_tpu_torch.train import distributed
    from scp_tpu_torch.train.data import ShardDataset, build_dataset
    from scp_tpu_torch.train.trainer import Trainer

    lead = distributed.is_lead()
    # only the switches the user set: the model's defaults are the others
    defaults = dict(static_knn=False, pallas_knn=False, pallas_attn=False, fused_edgeconv=True)
    switches = {k: getattr(args, k) for k, v in defaults.items() if getattr(args, k) != v}
    if lead:
        print(cfg.to_plain())
    seed = int(cfg.get("seed", cfg.train.get("seed", 42)))
    cfg.seed = seed

    dataset = build_dataset(cfg)
    trainer = Trainer(cfg, steps_per_epoch=dataset.steps_per_epoch(), device=cfg.get("device"),
                      **switches)

    # validation batches (bits/node curve in metrics.jsonl): held out when
    # cfg.data.val_root points at disjoint shards; without it, a
    # differently-seeded pass over the training shards; each rank holds its
    # slice of every batch
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
            process_index=dataset.process_index,
            process_count=dataset.process_count,
        )
        gen = val_ds.batches()
        val_batches = [next(gen) for _ in range(n_val)]

    if args.run_dir:
        run_dir = args.run_dir
    else:
        now = datetime.datetime.now()
        run_dir = os.path.join(cfg.train.get("run_root", "outputs"), str(cfg.train.type),
                               now.strftime("%Y-%m-%d"), now.strftime("%H-%M-%S"))
    if lead:
        print("saving in", run_dir)
        print("device:", trainer.device, f"x {trainer.world} ranks" if trainer.world > 1 else "")
    trainer.fit(dataset, run_dir, val_batches=val_batches)
    return trainer


if __name__ == "__main__":
    main()
