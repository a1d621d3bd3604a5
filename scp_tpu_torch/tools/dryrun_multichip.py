"""Multi-device dry run of the port (the twin of
__graft_entry__.dryrun_multichip).

    python -m scp_tpu_torch.tools.dryrun_multichip N [--device cpu]

Over N ranks it takes two real data-parallel training steps of the tiny
EHEM (configs/train_kitti_ehem.yaml with a 64-wide Swin, f32, global batch
N of one 64-node context each: train/distributed.py's step), then codes
the same 1,200-point spherical cloud as scp_tpu through the sharded codec
(the tiny EHEM at context 64, group N, N lane shards) with the lossless
check.  It prints scp_tpu's two lines.

On the cards (the default) the ranks run over NCCL, one per card, or over
gloo when N exceeds the cards (two ranks on one card for N = 2 there),
and the lane shards wrap around the cards; `--device cpu` runs N gloo
ranks and N shards on the CPU.

`step_worker` is the data-parallel step check that the tests and
chip_smoke.py phase 12 run in each rank (and in one process, as the
one-rank reference): one trainer step from given weights on given global
batches, with the loss, gradients, statistics and parameters it leaves.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def example_batch(rng, n_ctx: int, batch: int = 1):
    """__graft_entry__._example_batch: random (data, pos, label)."""
    data = np.stack([rng.integers(0, 19, (batch, n_ctx, 4)),
                     rng.integers(0, 9, (batch, n_ctx, 4)),
                     rng.integers(0, 255, (batch, n_ctx, 4))], axis=-1).astype(np.int32)
    pos = rng.random((batch, n_ctx, 3), dtype=np.float32)
    label = rng.integers(0, 255, (batch, n_ctx)).astype(np.int32)
    return data, pos, label


def tiny_config(n: int):
    """The dry run's training config: train_kitti_ehem.yaml, a 64-wide Swin,
    global batch n, f32."""
    from scp_tpu_torch.config import Config, load_config

    cfg = load_config("train_kitti_ehem.yaml", os.path.join(HERE, "configs"))
    cfg.model.swin = Config.wrap(dict(embed_dim=64, self_depths=[2, 2], cross_depths=[1],
                                      num_heads=2, window_size=16, mlp_ratio=2.0))
    cfg.data.batch_size = n
    cfg.bf16 = False
    return cfg


def train_worker(n: int, device: str) -> float:
    """One rank: two data-parallel steps on its row of the global batch;
    returns the last step's global mean loss."""
    from scp_tpu_torch.train import distributed
    from scp_tpu_torch.train.trainer import Trainer

    trainer = Trainer(tiny_config(n), steps_per_epoch=10, device=device)
    trainer.init_state()
    data, pos, label = example_batch(np.random.default_rng(0), 64, batch=n)
    r = distributed.rank()
    batch = {"data": data[r : r + 1], "pos": pos[r : r + 1], "label": label[r : r + 1]}
    trainer.train_step(batch)
    return float(trainer.train_step(batch))


def step_worker(spec: dict) -> dict:
    """One checked training step of this rank, then `timed` more.

    spec: cfg (a plain config dict), state (path of a torch.save'd
    state_dict), batches (global batches, dicts of numpy arrays: the
    first is the checked step's, the rest are timed), device, switches
    (EHEM's constructor switches).  Each rank takes its rows of every
    global batch.  Returns the global loss, every parameter's gradient
    (averaged over the ranks; rank 0 only, the others hold the same), the
    buffers after the update, a SHA-256 of the updated parameters' bytes,
    the kernel launches of the checked step and, when timed, the median
    s/step, the forward / backward / all-reduce / update seconds and the
    peak device memory."""
    import hashlib

    import torch

    from scp_tpu_torch.config import Config
    from scp_tpu_torch.tools.profile_train import counted_kernels, reset_counts
    from scp_tpu_torch.train import distributed
    from scp_tpu_torch.train.trainer import Trainer

    counted = counted_kernels()
    cfg = Config.wrap(spec["cfg"])
    trainer = Trainer(cfg, steps_per_epoch=1, device=spec["device"], **spec.get("switches", {}))
    trainer.init_state()
    trainer.model.load_state_dict(torch.load(spec["state"], map_location="cpu",
                                             weights_only=True))
    r, n = distributed.rank(), distributed.world_size()

    def local(batch):
        b = batch["data"].shape[0] // n
        return {k: v[r * b : (r + 1) * b] for k, v in batch.items()}

    def host(t):
        return t.detach().float().cpu()

    first, *timed = spec["batches"]
    reset_counts(counted.values())
    loss = float(trainer.train_step(local(first)))
    digest = hashlib.sha256()
    for p in trainer.model.parameters():
        digest.update(p.detach().cpu().numpy().tobytes())
    out = {"loss": loss, "rank": r, "world": n, "device": str(trainer.device),
           "launches": {k: fn.launches for k, fn in counted.items()},
           "grads": ({k: host(p.grad) for k, p in trainer.model.named_parameters()}
                     if r == 0 else None),
           "buffers": {k: host(b) for k, b in trainer.model.named_buffers()},
           "params_sha256": digest.hexdigest()}
    if timed:
        dev = trainer.device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        walls, split = [], {}
        for batch in timed:
            t = time.perf_counter()
            trainer.train_step(local(batch), timings=split)
            walls.append(time.perf_counter() - t)
        out["timed"] = {"median_s_per_step": float(np.median(walls)), "walls": walls,
                        "split_s": split,
                        "peak_memory_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                                           if dev.type == "cuda" else None)}
    return out


def steps_worker(specs: list) -> list:
    """step_worker over several specs in one rank (one spawn for all)."""
    return [step_worker(s) for s in specs]


def lidar_cloud(n: int = 1200, seed: int = 1) -> np.ndarray:
    """scp_tpu's dry-run cloud: uniform azimuth, elevation and range."""
    r = np.random.default_rng(seed)
    az = r.uniform(0, 2 * np.pi, n)
    el = r.uniform(-0.4, 0.2, n)
    rad = r.uniform(2.0, 60.0, n)
    return np.stack([rad * np.cos(el) * np.cos(az), rad * np.cos(el) * np.sin(az),
                     rad * np.sin(el)], 1)


def dryrun_multichip(n: int, device: str = "cuda", workdir: str | None = None,
                     timeout_s: float = 600.0) -> dict:
    """Two data-parallel training steps over n ranks, then the sharded
    codec roundtrip over n lane shards; prints scp_tpu's two lines and
    returns {"loss", "nodes", "bits", "devices"}."""
    import torch

    from scp_tpu_torch.codec.ehem_codec import EHEMCodec
    from scp_tpu_torch.codec.slices import split_levels
    from scp_tpu_torch.core.preprocess import preprocess_points
    from scp_tpu_torch.models.ehem import EHEM
    from scp_tpu_torch.models.layers import flax_init_
    from scp_tpu_torch.train import distributed

    dev = torch.device(device)
    losses = distributed.run_workers(train_worker, n, args=(n, device),
                                     backend=distributed.backend_for(dev, n), workdir=workdir,
                                     timeout_s=timeout_s)
    if len(set(losses)) != 1:
        raise AssertionError(f"the ranks report different global losses: {losses}")
    print(f"dryrun_multichip({n}): step ok, loss={losses[0]:.4f}", flush=True)

    if dev.type == "cuda":
        shards = [f"cuda:{i % torch.cuda.device_count()}" for i in range(n)]
    else:
        shards = ["cpu"] * n
    model = EHEM(self_depths=(2, 2), cross_depths=(1,), embed_dim=64, num_heads=2,
                 window_size=16, mlp_ratio=2.0, knn_k=4, device=shards[0])
    flax_init_(model, torch.Generator().manual_seed(0))
    codec = EHEMCodec(model, context_size=64, group_size=n, devices=shards)
    res = preprocess_points(lidar_cloud(), system="spher", qs=60.0 / 127)
    slices = split_levels(res.context, angular=True)
    stream, bits, _ = codec.encode_to_stream(slices)
    dec = codec.new_stream_decoder(stream, len(slices.occ_stream),
                                   coding_params=codec.coding_params())
    codes = codec.decode(dec, slices.max_level, np.array(slices.pos_mm, np.int64), angular=True,
                         ground_truth=slices.occ_stream, level_sizes=slices.level_sizes)
    if not (codes == slices.occ_stream).all():
        raise AssertionError("sharded codec roundtrip is not lossless")
    if n > 1 and codec.last_devices is None:
        raise AssertionError("no phase call was sharded")
    nodes = int(slices.occ_stream.shape[0])
    print(f"dryrun_multichip({n}): sharded codec roundtrip ok, {nodes} nodes, {bits} bits",
          flush=True)
    return {"loss": losses[0], "nodes": nodes, "bits": bits, "devices": codec.last_devices}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
