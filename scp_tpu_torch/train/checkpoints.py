"""Checkpoints of the port's trainer, and the JAX package's npz format
(the twin of scp_tpu/train/checkpoints.py without orbax).

A run checkpoint is one `torch.save` file, `<run_dir>/ckpt/epoch=E-step=S.pt`,
holding the parameters (and EHEM's BatchNorm statistics), the Adam
moments and the step: a resumed run continues bit for bit under
`torch.use_deterministic_algorithms(True)`, OctAttention's dropout
included.  It holds no generator state because it needs none: a step's
dropout masks are drawn from a generator seeded with (seed + 1, step)
(train/trainer.py::dropout_generator).  The codec CLI loads the file
(cli/codec_common.py::load_weights).  The bench-checkpoint format is
scp_tpu's: a compressed `.npz` of float16 leaves under flat
"params/<scope>/<leaf>" and "batch_stats/..." keys (no batch_stats for
OctAttention), which the port's codec (scp_tpu_torch.weights) and
scp_tpu's load_params_npz both read.

Data-parallel: every rank calls `save`, rank 0 writes (the state is
replicated) and the others wait at a barrier until the file is there;
every rank restores from it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from scp_tpu_torch import weights
from scp_tpu_torch.train import distributed


def _ckpt_dir(run_dir: str) -> str:
    return os.path.abspath(os.path.join(run_dir, "ckpt"))


def save(run_dir: str, trainer, epoch: int, step: int, final: bool = False) -> str:
    """Write the trainer's state; every epoch's file is kept.  Rank 0
    writes; every rank returns once the file is written."""
    path = os.path.join(_ckpt_dir(run_dir), f"epoch={epoch}-step={step}.pt")
    if distributed.is_lead():
        _write(path, trainer, epoch, step, final)
    distributed.barrier()
    return path


def _write(path: str, trainer, epoch: int, step: int, final: bool) -> None:
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        payload = {
            "model": {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()},
            "opt_state": trainer.opt.state_dict(),
            "meta": {"epoch": epoch, "step": step},
        }
        tmp = path + ".tmp"  # a killed run never leaves a truncated checkpoint
        torch.save(payload, tmp)
        os.replace(tmp, path)
    if final:
        with open(os.path.join(os.path.dirname(path), "latest.txt"), "w") as f:
            f.write(os.path.basename(path))


def latest_checkpoint(run_dir: str) -> str | None:
    d = _ckpt_dir(run_dir)
    if not os.path.isdir(d):
        return None
    names = [n for n in os.listdir(d)
             if n.startswith("epoch=") and n.endswith(".pt") and n[:-3].split("step=")[-1].isdigit()]
    if not names:
        return None
    return os.path.join(d, max(names, key=lambda n: int(n[:-3].split("step=")[-1])))


def restore(path: str, trainer) -> dict:
    """Load a checkpoint into an initialized trainer; returns its meta."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    trainer.model.load_state_dict(payload["model"], strict=True)
    trainer.opt.load_state_dict(payload["opt_state"])
    meta = payload.get("meta", {})
    trainer.step = int(meta.get("step", 0))
    return meta


def save_params_npz(path: str, model: torch.nn.Module) -> None:
    """The model's parameters and statistics as scp_tpu's bench npz:
    flat flax keys, float16 leaves (encoder and decoder both load the same
    rounded values)."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, key)
            else:
                flat[key] = v.astype(np.float16) if v.dtype.kind == "f" else v

    walk(weights.to_variables(model), "")
    np.savez_compressed(path, **flat)


def load_params_npz(path: str) -> dict:
    """Inverse of save_params_npz: nested {"params": ..., "batch_stats": ...}
    of float32 leaves, pre-fusion q/k/v scopes fused."""
    return weights.read_npz(path)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def filter_compatible(pretrained: dict, reference: dict) -> dict:
    """Keep only leaves whose path and shape match the reference tree
    (the reference's partial-checkpoint warm start, ehem.py:212-222)."""
    flat_p = dict(_flat(pretrained))
    out: dict = {}
    for path, ref_leaf in _flat(reference):
        leaf = flat_p.get(path)
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        ok = leaf is not None and np.shape(leaf) == np.shape(ref_leaf)
        node[path[-1]] = leaf if ok else ref_leaf
    return out
