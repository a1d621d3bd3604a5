"""Trainer of EHEM and OctAttention, on one device or data-parallel over
ranks (the twin of scp_tpu/train/trainer.py and its Mesh("data") step).

  * loss = cross-entropy / ln 2, bits per occupancy symbol, with scp_tpu's
    one-hot masked sum: the pad label 255 matches no class, so a pad node
    adds 0 to the sum but still counts in the mean;
  * Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8 outside the
    square root) and StepLR stepped per epoch, read at the step count
    before the update as optax.scale_by_schedule reads it;
  * compute in the config's dtype (bf16 by default), f32 master
    parameters and optimizer state;
  * a checkpoint every epoch, all kept, with the archived config and a
    metrics.jsonl of the JAX trainer's keys.

The model is the config's (models.build_model).  EHEM runs the
hand-written kernels in its forward (A, B, C; D and E with pallas_knn /
pallas_attn) and scp_tpu's custom_vjp backward; OctAttention is plain
PyTorch, as scp_tpu's is einsums.  OctAttention's dropout masks come from
a generator seeded with (seed + 1, step) (`dropout_generator`), the
twin of scp_tpu's fold_in(PRNGKey(seed + 1), step): a step's masks are a
function of the seed and the step alone.

Data-parallel (train/distributed.py): inside a process group of P ranks
each rank trains on its card (cuda:LOCAL_RANK) with its slice of every
global batch; BatchNorm takes the global batch's statistics and dropout
the global batch's masks, the gradients are averaged over the ranks after
the backward, and every rank applies the same Adam update, so the step is
scp_tpu's jitted step over the batch-sharded global array: the mean loss
of the global batch, identical parameters on every rank.  Rank 0 writes
the run dir (config, metrics, checkpoints); every rank restores.  With
one rank nothing of this runs.
"""

from __future__ import annotations

import json
import math
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from scp_tpu_torch import resolve_device
from scp_tpu_torch.config import Config, save_config
from scp_tpu_torch.models import build_model
from scp_tpu_torch.models.layers import flax_init_
from scp_tpu_torch.train import distributed
from scp_tpu_torch.utils import profiling

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


def make_lr_schedule(cfg, steps_per_epoch: int):
    base = float(cfg.train.lr)
    step_size = int(cfg.train.lr_scheduler.step_size)
    gamma = float(cfg.train.lr_scheduler.gamma)

    def schedule(step):
        epoch = step // steps_per_epoch
        return base * gamma ** (epoch // step_size)

    return schedule


def cross_entropy_bits(logits, labels):
    """CE / ln 2, average bits per occupancy symbol over every node, pads
    (label 255, no class) included as zeros.  Not F.cross_entropy with
    ignore_index, which would drop the pads from the mean."""
    logp = F.log_softmax(logits.float(), dim=-1)
    j = torch.arange(logp.shape[-1], device=logp.device, dtype=labels.dtype)
    ll = torch.where(j == labels[..., None], logp, 0.0).sum(dim=-1)
    return -ll.mean() / math.log(2.0)


def make_optimizer(params, lr: float) -> torch.optim.Adam:
    """optax.adam's update: mu / (1 - b1^t) / (sqrt(nu / (1 - b2^t)) + eps)."""
    return torch.optim.Adam(params, lr=lr, betas=(ADAM_B1, ADAM_B2), eps=ADAM_EPS)


def dropout_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step `step`'s dropout masks, on `device`: seeded
    from (seed + 1, step) through numpy's SeedSequence."""
    state = np.random.SeedSequence([seed + 1, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    """`switches` are EHEM constructor arguments scp_tpu reads from the
    environment (static_knn, pallas_knn, pallas_attn, fused_edgeconv) and
    the port's plain_seams; any of them on another model is a ValueError."""

    def __init__(self, cfg: Config, steps_per_epoch: int, device=None, **switches):
        self.cfg = cfg
        self.steps_per_epoch = steps_per_epoch
        self.rank, self.world = distributed.rank(), distributed.world_size()
        dev = resolve_device(device)
        if dev.type == "cuda" and self.world > 1:
            if dev.index is None:  # the rank's card
                dev = torch.device("cuda", distributed.local_rank() % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        self.device = dev
        dtype = torch.bfloat16 if cfg.get("bf16", True) else torch.float32
        self.model = build_model(cfg, dtype, device=self.device, **switches)
        self.seed = int(cfg.get("seed", 42))
        self.schedule = make_lr_schedule(cfg, steps_per_epoch)
        self.opt: torch.optim.Adam | None = None
        self.step = 0

    # -- init -------------------------------------------------------------

    def init_state(self):
        """Fresh parameters from the config's seed (flax's initializers),
        warm-started from cfg.train.load_pretrain when set; a new Adam
        state; step 0."""
        from scp_tpu_torch.train import checkpoints as ckpt
        from scp_tpu_torch.weights import load_into, to_variables

        flax_init_(self.model, torch.Generator().manual_seed(self.seed))
        path = self.cfg.train.get("load_pretrain")
        if path:
            if not str(path).endswith(".npz"):
                raise ValueError(f"load_pretrain {path!r}: the port warm-starts from a bench "
                                 ".npz (orbax run directories are the JAX package's)")
            # params only, as scp_tpu: the BatchNorm statistics (EHEM's) stay fresh
            pre = ckpt.load_params_npz(path)["params"]  # pre-fusion q/k/v scopes fused
            now = to_variables(self.model)
            load_into(self.model, {**now, "params": ckpt.filter_compatible(pre, now["params"])})
            print(f"warm-started params from {path}")
        self.model.train()
        self.opt = make_optimizer(self.model.parameters(), self.schedule(0))
        self.step = 0

    # -- one step ---------------------------------------------------------

    def _batch(self, batch):
        dev = self.device
        return (torch.as_tensor(batch["data"]).to(dev, non_blocking=True),
                torch.as_tensor(batch["pos"]).to(dev, non_blocking=True),
                torch.as_tensor(batch["label"]).to(dev, non_blocking=True))

    def _forward(self, data, pos):
        """The model in train mode; a model that drops (OctAttention with
        dropout > 0) gets the generator of this step's masks."""
        if getattr(self.model, "dropout", 0.0) > 0.0:
            return self.model(data, pos,
                              generator=dropout_generator(self.seed, self.step, self.device),
                              drop_rows=(self.rank, self.world))
        return self.model(data, pos)

    def train_step(self, batch, timings: dict | None = None):
        """One Adam step on `batch` (this rank's rows of the global batch);
        returns the global batch's mean loss (a 0-d tensor on the device).
        Its parts are the spans train.forward, train.backward,
        train.allreduce (data-parallel only) and train.update.  With
        `timings`, each part synchronizes before it ends and its seconds
        are added to timings[part]."""
        if self.opt is None:
            raise RuntimeError("call init_state first")
        with self._part("forward", timings):
            self.opt.zero_grad(set_to_none=True)
            self.model.train()
            data, pos, label = self._batch(batch)
            loss = cross_entropy_bits(self._forward(data, pos), label)
            self._fence(timings)
        with self._part("backward", timings):
            loss.backward()
            self._fence(timings)
        if self.world > 1:
            with self._part("allreduce", timings):
                distributed.average_gradients(self.model.parameters())
                loss = distributed.global_mean(loss)
                self._fence(timings)
        with self._part("update", timings):
            lr = self.schedule(self.step)  # the count before the update, as optax reads it
            for group in self.opt.param_groups:
                group["lr"] = lr
            self.opt.step()
            self.step += 1
            self._fence(timings)
        return loss.detach()

    @staticmethod
    def _part(name: str, timings: dict | None):
        """The span of one part of a step; timed into timings[name] when asked."""
        if timings is None:
            return profiling.span(f"train.{name}")

        def add(seconds):
            timings[name] = timings.get(name, 0.0) + seconds

        return profiling.timed(f"train.{name}", add)

    def _fence(self, timings: dict | None) -> None:
        if timings is not None:
            _sync(self.device)

    # -- validation ---------------------------------------------------------

    @torch.no_grad()
    def evaluate(self, val_batches) -> float:
        """Mean held-out bits/node over a fixed batch list, in eval mode
        (running BatchNorm, no dropout); data-parallel, each rank holds its
        rows of every batch and the means are averaged over the ranks."""
        was = self.model.training
        self.model.eval()
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        try:
            for batch in val_batches:
                data, pos, label = self._batch(batch)
                total += cross_entropy_bits(self.model(data, pos), label).double()
        finally:
            self.model.train(was)
        return float(distributed.global_mean(total)) / max(len(val_batches), 1)

    # -- loop -------------------------------------------------------------

    def fit(self, dataset, run_dir: str, epochs: int | None = None, resume: bool = False,
            val_batches=None):
        from scp_tpu_torch.train import checkpoints as ckpt
        from scp_tpu_torch.train.data import prefetch

        cfg = self.cfg
        epochs = epochs or int(cfg.train.epoch)
        # the run dir is rank 0's: parameters are replicated, so its copy
        # is complete, and the ranks may share one filesystem
        lead = distributed.is_lead()
        os.makedirs(run_dir, exist_ok=True)
        if lead:
            save_config(cfg, run_dir)
        metrics_path = os.path.join(run_dir, "metrics.jsonl") if lead else os.devnull

        self.init_state()
        start_epoch = 0
        resume_from = cfg.train.get("load_ckpt") or (
            ckpt.latest_checkpoint(run_dir) if resume else None)
        if resume_from:
            meta = ckpt.restore(resume_from, self)
            start_epoch = int(meta.get("epoch", -1)) + 1
            print(f"resumed from {resume_from} at epoch {start_epoch}")

        log_every = int(cfg.train.get("log_every", 50))
        val_every = int(cfg.train.get("val_every", 500))
        step = self.step
        # opened after the resume step is known, so no batch is drawn off-schedule
        gen = prefetch(dataset.batches(start_step=step), depth=2)
        t0 = time.time()
        with open(metrics_path, "a") as mf:
            for epoch in range(start_epoch, epochs):
                for _ in range(self.steps_per_epoch):
                    loss = self.train_step(next(gen))
                    step += 1
                    if step % log_every == 0 or step == 1:
                        loss = float(loss)
                        rec = {"step": step, "epoch": epoch, "train_loss": loss,
                               "lr": float(self.schedule(step)), "wall": time.time() - t0}
                        mf.write(json.dumps(rec) + "\n")
                        mf.flush()
                        if lead:
                            print(f"epoch {epoch} step {step} loss {loss:.4f} bits/node",
                                  flush=True)
                    if val_batches and val_every and step % val_every == 0:
                        val = self.evaluate(val_batches)
                        rec = {"step": step, "epoch": epoch, "val_bits_per_node": val,
                               "wall": time.time() - t0}
                        mf.write(json.dumps(rec) + "\n")
                        mf.flush()
                        if lead:
                            print(f"epoch {epoch} step {step} VAL {val:.4f} bits/node",
                                  flush=True)
                if cfg.train.get("ckpt_every_epoch", True):
                    ckpt.save(run_dir, self, epoch=epoch, step=step)
        ckpt.save(run_dir, self, epoch=epochs - 1, step=step, final=True)
        return self
