"""EHEM training steps through the program's trainer on one card.

Traffic parameters (traffic/<name>.json): batch (windows per rank and
step), context (nodes per window), clouds and points / lidar_level
(the training shards: sweeps of the sweeps traffic's generator, drawn from
the seed, as (N, 4, 6) shards of the reference's octree written under
TMPDIR in set-up), checked (the first steps, in set-up, that the
reference follows), traced (steps profiled after the window in a
--trace 1 run).  Batches come from the program's data pipeline
(train/data.py's ShardDataset behind its prefetch thread) inside the
window; each step is Trainer.train_step ending in a synchronise.
"""

from __future__ import annotations

import math
import os
import shutil
import tempfile
import time

import numpy as np

from benchmark.harness.common import whole_units
from benchmark.harness.synth import seed_rng, synth_sweep


def make_shards(out_dir, seed, clouds, points, lidar_level) -> list:
    """Training shards from the seed, written as `cloud<i>_<rows>.npy`."""
    from benchmark.reference.octree import Octree, kitti_qs, spherical_grid

    rng = seed_rng(seed, 2)
    paths = []
    for i in range(clouds):
        rows = Octree(spherical_grid(synth_sweep(rng, points), kitti_qs(lidar_level))).shard()
        path = os.path.join(out_dir, f"cloud{i:03d}_{rows.shape[0]}.npy")
        np.save(path, rows)
        paths.append(path)
    return paths


def program_config(p, shards_dir):
    """The program's config of the training recipe (configs/train_kitti_ehem.yaml
    with the configuration's widths and the traffic's batch)."""
    from scp_tpu_torch.config import Config, load_config

    cfg = load_config("train_kitti_ehem.yaml", config_dir=os.path.join(p["root"], "configs"))
    w, tr = p["config"]["widths"], p["traffic"]
    cfg.model.swin = Config.wrap(dict(embed_dim=w["embed_dim"], self_depths=w["self_depths"],
                                      cross_depths=w["cross_depths"], num_heads=w["num_heads"],
                                      window_size=w["window_size"], mlp_ratio=w["mlp_ratio"]))
    cfg.model.token_num, cfg.model.max_level = w["token_num"], w["max_level"]
    cfg.data.root = os.path.join(shards_dir, "*.npy")
    cfg.data.batch_size = tr["batch"]
    cfg.model.context_size = cfg.data.context_size = tr["context"]
    cfg.data.vari_data_len = False
    cfg.bf16 = p["config"]["dtype"] == "bfloat16"
    cfg.remat = False
    cfg.seed = int(p["seed"]) % (1 << 63)
    cfg.train.lr = tr["lr"]
    cfg.train.load_pretrain = p["weights_path"]
    return cfg


def train_main(p, shards_dir):
    """The trainer's set-up, checked steps, window and traced steps."""
    import torch
    from torch.profiler import record_function

    from scp_tpu_torch.train.data import build_dataset, prefetch
    from scp_tpu_torch.train.trainer import ADAM_B1, Trainer

    from benchmark.reference.train import leaf_norms

    dev = torch.device("cpu") if p["rehearse"] else torch.device("cuda", 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    cfg = program_config(p, shards_dir)
    ds = build_dataset(cfg)
    c = p["config"]
    trainer = Trainer(cfg, steps_per_epoch=ds.steps_per_epoch(), device=dev,
                      static_knn=c["static_knn"], pallas_knn=c["pallas_knn"],
                      pallas_attn=c["pallas_attn"])
    trainer.init_state()
    sync()
    init_wall = time.time()
    plant(p.get("fault"), trainer)
    gen = prefetch(ds.batches(), depth=2)
    named = list(trainer.model.named_parameters())
    start = {n: t.detach().clone() for n, t in named}
    batches, losses, g1 = [], [], None
    fault = p.get("fault")

    def feed():
        b = next(gen)
        if fault == "half_batch":
            half = b["data"].shape[0] // 2
            return {k: v[:half] for k, v in b.items()}, b
        return b, b

    for s in range(p["traffic"]["checked"]):
        fed, b = feed()
        batches.append(b)
        losses.append(float(trainer.train_step(fed)))
        if s == 0:
            st = trainer.opt.state
            g1 = leaf_norms({n: st[t]["exp_avg"] / (1 - ADAM_B1) if t in st else 0 * t
                             for n, t in named}, ".", 0)
    change = leaf_norms({n: t.detach() - start[n] for n, t in named}, ".", 0)
    del start
    sync()
    setup_wall = time.time()
    spans = []
    ranged = [False]

    def step():
        t0 = time.perf_counter()
        if ranged[0]:
            with record_function("bench.step"):
                trainer.train_step(feed()[0])
                sync()
        else:
            trainer.train_step(feed()[0])
            sync()
        spans.append(time.perf_counter() - t0)

    units, window_s = whole_units(lambda i: step(), p["seconds"])
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    trace = None
    if p["trace"]:
        from benchmark.harness.trace import capture

        ranged[0] = True
        trace = capture(lambda: [step() for _ in range(p["traffic"]["traced"])], dev.index)
        del spans[len(spans) - p["traffic"]["traced"]:]
    return {"spans": spans, "units": units, "window_s": window_s,
            "setup_wall": setup_wall, "init_wall": init_wall, "peak": peak, "trace": trace,
            "losses": losses, "g1": g1, "change": change,
            "batches": [(b["data"], b["pos"], b["label"]) for b in batches]}


def plant(fault, trainer):
    """Faults planted under the timed path, for the fault tests only."""
    if fault in (None, "half_batch"):
        return
    if fault == "frozen":  # a step that leaves the parameters as they were
        trainer.opt.step = lambda *a, **k: None
    else:
        raise ValueError(f"unknown fault {fault!r}")


def run(ctx) -> dict:
    import torch

    tr = ctx.traffic
    tmp = tempfile.mkdtemp(prefix="bench_train_", dir=os.environ.get("TMPDIR"))
    try:
        ctx.setup_part("imports and CUDA")
        shards = make_shards(tmp, ctx.seed, tr["clouds"], tr["points"], tr["lidar_level"])
        ctx.setup_part("shards")
        p = {"config": ctx.config, "traffic": tr, "seed": ctx.seed, "seconds": ctx.seconds,
             "trace": ctx.trace, "rehearse": ctx.rehearse, "root": ctx.root,
             "weights_path": ctx.weights_file(tmp), "fault": ctx.fault}
        lead = train_main(p, tmp)
        ctx.parts.append(("trainer", lead["init_wall"] - ctx.t0_wall))
        ctx.parts.append(("checked steps", lead["setup_wall"] - ctx.t0_wall))
        ctx.setup_s = ctx.parts[-1][1]
        window_s, units = lead["window_s"], lead["units"]
        nodes = units * tr["batch"] * tr["context"]
        from benchmark.harness import products

        per_row = products.total(products.window_products(
            ctx.config["widths"], ctx.config["static_knn"], tr["context"]))
        record = {"window_s": window_s, "units": units, "chips": 1,
                  "spans": {"step": lead["spans"]},
                  "products": {"flops": 3 * per_row * tr["batch"] * units},
                  "memory_peak_bytes": lead["peak"],
                  "traces": [lead["trace"]] if ctx.trace else None}
        from benchmark.checks import train as check

        t0 = time.perf_counter()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        checks = check.compare(ctx, shards, lead)
        return {"e2e": {"train_nodes_per_s": nodes / window_s}, "record": record,
                "checks": checks, "check_s": time.perf_counter() - t0, "attempted": units,
                "failed": sum(not math.isfinite(x) for x in lead["losses"]),
                "memory_peak_bytes": record["memory_peak_bytes"]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
