"""Per-device work of the sharded codec and the data-parallel trainer (the
twin of scp_tpu/tools/scaling_curve.py).

    python -m scp_tpu_torch.tools.scaling_curve [--device cpu]

scp_tpu's narrow model (embed 64, self depths (2, 2), cross (1,), 2 heads,
window 16, MLP ratio 2, k 4) at context 512, for n = 1, 2, 4 and 8
devices.  A wall clock on shared host cores cannot show a speedup; what
is shown is the products each device computes (scp_tpu reads them from
XLA's per-device cost analysis):

  * codec: one grouped phase-1 call of `EHEMCodec(devices=..., group_size=8)`,
    its 8 lanes split over the n shards (`_sharded_phase1`); the lanes each
    shard received, priced by `EHEM.phase1_flops`; the largest shard is the
    per-device work;
  * training: one step of the data-parallel trainer in each of n ranks of
    one process group (`train/distributed.py::run_workers`: NCCL with a
    card per rank, gloo on the CPU or for more ranks than cards), each on
    its 8 / n rows of one global batch of 8, its gradients averaged over
    the group; the largest rank's products are the per-rank work.

Runs on the card unless given `--device cpu`.  On the card, shard and rank
i take cuda:(i mod cards): with fewer cards than n, several share one,
which changes their time and not their products.  There the hand-written
kernels run through ctypes, out of FlopCounterMode's sight, so the closed
form prices what each shard and rank received: phase-1 products of its
lanes, and 3x the forward products of its rows (the model-FLOPs
convention of tools/profile_codec.py).  On the CPU the shards are
`utils.env.force_cpu(n)`, and FlopCounterMode counts each shard's
phase-1 call (held equal to the closed form) and each rank's whole step,
forward and backward, where it runs.

Prints scp_tpu's table and ratio lines.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

CONTEXT = 512
GROUP = 8
BATCH = 8
DEVICES = (1, 2, 4, 8)
NARROW = dict(self_depths=(2, 2), cross_depths=(1,), embed_dim=64, num_heads=2,
              window_size=16, mlp_ratio=2.0, knn_k=4)


def narrow_model(device="cpu"):
    from scp_tpu_torch.models.ehem import EHEM
    from scp_tpu_torch.models.layers import flax_init_

    model = EHEM(**NARROW, device=device)
    return flax_init_(model, torch.Generator().manual_seed(0))


def shard_devices(device: torch.device, n: int) -> list:
    """The n lane shards' devices: the CPU n times, or the cards in turn."""
    from scp_tpu_torch.utils.env import force_cpu

    if device.type == "cpu":
        return force_cpu(n)
    return [torch.device("cuda", i % torch.cuda.device_count()) for i in range(n)]


def codec_flops_per_device(model, n: int) -> float:
    """The largest shard's products in one sharded phase-1 call."""
    from torch.utils.flop_counter import FlopCounterMode

    from scp_tpu_torch.codec.ehem_codec import EHEMCodec

    codec = EHEMCodec(model, context_size=CONTEXT, group_size=GROUP,
                      devices=shard_devices(model.device, n))
    counted = []

    def counting(fn):
        def run(*args, **kwargs):
            with FlopCounterMode(display=False) as fc:
                out = fn(*args, **kwargs)
            counted.append(fc.get_total_flops())
            return out
        return run

    on_cpu = model.device.type == "cpu"
    if on_cpu:
        for rep in codec.replicas:
            rep.decode_phase1 = counting(rep.decode_phase1)
    try:
        data_buf, pos_buf = codec._root_bufs(GROUP * CONTEXT)
        with torch.no_grad():
            _, parts = codec._sharded_phase1(data_buf, pos_buf, 0, 2**31 - 1, 0,
                                             np.float32(1.0), GROUP, CONTEXT)
    finally:
        if on_cpu:
            for rep in codec.replicas:
                del rep.decode_phase1
    lanes = [nl for *_, nl in parts]
    if len(lanes) != n or sum(lanes) != GROUP or (n > 1 and len(codec.last_devices) != n):
        raise AssertionError(f"{n} devices ran shards of {lanes} lanes on {codec.last_devices}")
    priced = [model.phase1_flops(nl, CONTEXT) for nl in lanes]
    if on_cpu and counted != priced:
        raise AssertionError(f"FlopCounterMode counted {counted}, the closed form {priced}")
    return float(max(priced))


def train_config():
    from scp_tpu_torch.config import load_config

    cfg = load_config("train_kitti_ehem.yaml", "configs")
    cfg.model.swin = dict(embed_dim=64, self_depths=[2, 2], cross_depths=[1], num_heads=2,
                          window_size=16, mlp_ratio=2.0)
    cfg.data.batch_size = BATCH
    cfg.bf16 = False
    return cfg


def global_batch() -> dict:
    rng = np.random.default_rng(0)
    return {"data": rng.integers(0, 9, (BATCH, CONTEXT, 4, 3)).astype(np.int32),
            "pos": rng.random((BATCH, CONTEXT, 3)).astype(np.float32),
            "label": rng.integers(0, 255, (BATCH, CONTEXT)).astype(np.int32)}


def train_worker(device: str) -> dict:
    """One rank: a trainer step on its rows of the global batch, and the
    products it computed."""
    from torch.utils.flop_counter import FlopCounterMode

    from scp_tpu_torch.train import distributed
    from scp_tpu_torch.train.trainer import Trainer

    trainer = Trainer(train_config(), steps_per_epoch=10, device=device)
    trainer.init_state()
    r, world = distributed.rank(), distributed.world_size()
    rows = BATCH // world
    local = {k: v[r * rows : (r + 1) * rows] for k, v in global_batch().items()}
    if trainer.device.type == "cpu":
        with FlopCounterMode(display=False) as fc:
            trainer.train_step(local)
        flops = fc.get_total_flops()
    else:
        trainer.train_step(local)
        flops = 3 * trainer.model.forward_flops(rows, CONTEXT)
    return {"rank": r, "world": world, "rows": int(local["data"].shape[0]),
            "device": str(trainer.device), "flops": float(flops)}


def train_flops_per_rank(device: torch.device, n: int) -> float:
    from scp_tpu_torch.train import distributed

    ranks = distributed.run_workers(train_worker, n, args=(str(device),),
                                    backend=distributed.backend_for(device, n))
    if [r["world"] for r in ranks] != [n] * n or sum(r["rows"] for r in ranks) != BATCH:
        raise AssertionError(f"{n} ranks stepped on {[(r['world'], r['rows']) for r in ranks]}")
    return max(r["flops"] for r in ranks)


def main(argv=None):
    from scp_tpu_torch import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    model = narrow_model(dev)
    how = ("FlopCounterMode" if dev.type == "cpu"
           else "closed form: phase-1 lanes, 3x forward rows")
    print(f"# {dev.type}; products per device, {how}")
    print(f"{'devices':>8} {'codec p1 GFLOP/dev':>20} {'train GFLOP/dev':>18}")
    rows = []
    for n in DEVICES:
        f_codec = codec_flops_per_device(model, n) / 1e9
        f_train = train_flops_per_rank(dev, n) / 1e9
        rows.append((n, f_codec, f_train))
        print(f"{n:>8} {f_codec:>20.3f} {f_train:>18.3f}", flush=True)
    r1 = rows[0]
    for n, fc, ft in rows[1:]:
        print(f"# {n} devices: codec work/dev = {fc / r1[1]:.3f}x of 1-dev, "
              f"train work/dev = {ft / r1[2]:.3f}x (ideal {1 / n:.3f}x)")
    return rows


if __name__ == "__main__":
    main()
