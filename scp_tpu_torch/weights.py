"""Carry JAX-package weights into the port's modules, in memory.

Mirrors scp_tpu/train/checkpoints.py::load_params_npz and
fuse_qkv_params (:124-170): a checkpoint `.npz` holds flat
"params/<scope>/.../<leaf>" and "batch_stats/..." keys (float16 leaves
come back as float32); pre-fusion Swin attention scopes with separate
query/key/value Dense kernels are concatenated into the fused q|k|v
(self) or k|v (cross) projections.

Leaf names map onto the port's state_dict:
  kernel (in, out)     -> weight (out, in)  (transposed: nn.Linear layout)
  embedding            -> weight
  scale (LN / BN)      -> weight
  bias, rel_pos_bias   -> same name
  batch_stats mean/var -> running_mean / running_var
Nothing is written to disk.

`to_variables(model)` is the other direction: the port's parameters and
statistics as the JAX package's nested variables (kernels transposed back
to (in, out), leaves named by their flax scope), what
scp_tpu_torch.train.checkpoints.save_params_npz writes.
"""

from __future__ import annotations

import numpy as np
import torch

_LEAF = {"kernel": "weight", "embedding": "weight", "scale": "weight"}
_STATS = {"mean": "running_mean", "var": "running_var"}


def read_npz(path: str) -> dict:
    """Nested {"params": ..., "batch_stats": ...} dict of numpy arrays."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            v = z[key]
            node[parts[-1]] = v.astype(np.float32) if v.dtype.kind == "f" else v
    return fuse_qkv(tree)


def fuse_qkv(tree):
    """Concatenate pre-fusion query/key/value Dense scopes (only those of a
    Swin WindowAttention1D, which always carry `proj` beside them)."""

    def walk(node, in_cross):
        if not isinstance(node, dict):
            return node
        if {"query", "key", "value", "proj"} <= set(node):

            def cat(names):
                parts = [node[n] for n in names]
                out = {"kernel": np.concatenate([np.asarray(p["kernel"]) for p in parts], -1)}
                if all("bias" in p for p in parts):
                    out["bias"] = np.concatenate([np.asarray(p["bias"]) for p in parts], -1)
                return out

            rest = {k: walk(v, in_cross) for k, v in node.items()
                    if k not in ("query", "key", "value")}
            if in_cross:
                return {**rest, "query": node["query"], "kv": cat(["key", "value"])}
            return {**rest, "qkv": cat(["query", "key", "value"])}
        return {k: walk(v, in_cross or k == "swin_cross") for k, v in node.items()}

    return walk(tree, False)


def _flatten(node, prefix=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _flatten(v, prefix + (str(k),))
    else:
        yield prefix, np.asarray(node)


def to_state_dict(variables: dict) -> dict[str, torch.Tensor]:
    """Flax variables (nested numpy dict) -> the port's state_dict keys."""
    sd: dict[str, torch.Tensor] = {}
    for path, v in _flatten(variables):
        collection, *scope, leaf = path
        if collection == "params":
            name = _LEAF.get(leaf, leaf)
            if leaf == "kernel":
                v = v.T
        elif collection == "batch_stats":
            name = _STATS[leaf]
        else:
            raise KeyError(f"unknown variable collection {collection!r}")
        key = ".".join([*scope, name])
        if key in sd:
            raise KeyError(f"two leaves map onto {key}")
        sd[key] = torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
    return sd


def to_variables(model: torch.nn.Module) -> dict:
    """The port's state_dict -> flax variables {"params": ..., "batch_stats":
    ...}, nested numpy f32 dicts (inverse of to_state_dict)."""
    from torch import nn

    leaf_of = {}  # module path -> {param name: flax leaf}
    for path, mod in model.named_modules():
        if isinstance(mod, nn.Embedding):
            leaf_of[path] = {"weight": "embedding"}
        elif hasattr(mod, "kernel") and callable(mod.kernel):  # layers.Dense
            leaf_of[path] = {"weight": "kernel"}
        elif "weight" in dict(mod.named_parameters(recurse=False)):  # LayerNorm, BatchNorm
            leaf_of[path] = {"weight": "scale"}
    stats = {v: k for k, v in _STATS.items()}
    out: dict = {}
    for key, t in model.state_dict().items():
        *scope, name = key.split(".")
        v = t.detach().float().cpu().numpy()
        if name in stats:
            collection, leaf = "batch_stats", stats[name]
        else:
            collection = "params"
            leaf = leaf_of.get(".".join(scope), {}).get(name, name)
            if leaf == "kernel":
                v = v.T
        node = out.setdefault(collection, {})
        for p in scope:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(v)
    return out


def load_into(model: torch.nn.Module, source) -> torch.nn.Module:
    """Fill every parameter and buffer of `model` from a `.npz` path or a
    nested numpy dict; every source leaf must be consumed.  Values are
    cast to each parameter's dtype and device by load_state_dict."""
    variables = read_npz(source) if isinstance(source, str) else fuse_qkv(source)
    sd = to_state_dict(variables)
    want = model.state_dict()
    missing = sorted(set(want) - set(sd))
    unused = sorted(set(sd) - set(want))
    if missing or unused:
        raise KeyError(f"weights do not match the model: missing {missing[:8]}, "
                       f"unused {unused[:8]} ({len(missing)} / {len(unused)})")
    for k, t in sd.items():
        if tuple(t.shape) != tuple(want[k].shape):
            raise ValueError(f"{k}: shape {tuple(t.shape)} != model {tuple(want[k].shape)}")
    model.load_state_dict(sd, strict=True)
    return model
