"""Reference SCP checkpoint -> the port's weight file (the twin of
scp_tpu/tools/import_torch_ckpt.py).

The reference publishes trained torch / Lightning checkpoints.  This tool
maps a reference state_dict onto the flax-layout variable tree and writes
it as the `.npz` that `scp_tpu_torch.weights.read_npz` reads (and the JAX
package's `load_params_npz`), with flat "params/..." and "batch_stats/..."
keys:

    python -m scp_tpu_torch.tools.import_torch_ckpt \\
        --ckpt epoch=7-step=xxxx.ckpt --model ehem --out ehem_ref.npz

The mapping is pure key and layout rewriting, the same rules as scp_tpu's:
torch Linear weights (out, in) transpose to kernels (in, out), Conv2d 1x1
kernels (F, C, 1, 1) become (C, F) kernels, LayerNorm weights become
scales, BatchNorm running statistics land in batch_stats.  Separate Swin
query / key / value projections are fused by `weights.fuse_qkv`, the
column-block concatenation that scp_tpu's checkpoints use (EHEM only).

The written tree is checked against the port model's own parameter and
buffer names and shapes (`verify_tree`, through `weights.load_into` on a
model built on `--device`; the card unless `--device cpu`) unless
`--no_verify` is given.  Checkpoints load with `torch.load(...,
weights_only=True)`; full unpickling, which runs code from the file, only
with `--trust_pickle`.
"""

from __future__ import annotations

import argparse
import re
import sys

import numpy as np

# torch buffers with no flax counterpart (recomputed or baked into code)
_SKIP = (
    "num_batches_tracked",
    "relative_position_index",  # recomputed (swin1d.py rel_bias)
    "position_enc.pe",  # sinusoidal table, recomputed
    "criterion",
)
_SKIP_EXACT = ("mask",)  # OctAttention causal-mask buffer


def _t(w):
    return np.ascontiguousarray(np.asarray(w).T)


def _id(w):
    return np.asarray(w)


def _conv1x1(w):
    return np.ascontiguousarray(np.asarray(w)[:, :, 0, 0].T)


def _seq(i: str) -> str:
    """nn.Sequential Linear index (0, 2, 4) -> MLP dense index."""
    return f"dense_{int(i) // 2}"


_WB = {"weight": "kernel", "bias": "bias"}
_LN = {"weight": "scale", "bias": "bias"}

_SWIN = r"swin_(self|cross)_transformer\.layers\.(\d+)\."
_BLOCK = _SWIN + r"blocks\.(\d+)\."


def _block(m) -> str:
    return f"params/swin_{m[1]}/stage_{m[2]}/block_{m[3]}"


# (reference key pattern, flax path of the match, transform; None = Linear:
# the weight transposes, the bias passes)
_EHEM_RULES = [
    (r"geo_feat_generator\.conv(\d)\.0\.weight",
     lambda m: f"params/geo/conv{m[1]}/conv/kernel", _conv1x1),
    (r"geo_feat_generator\.conv(\d)\.1\.(weight|bias)",
     lambda m: f"params/geo/conv{m[1]}/bn/{_LN[m[2]]}", _id),
    (r"geo_feat_generator\.conv(\d)\.1\.running_(mean|var)",
     lambda m: f"batch_stats/geo/conv{m[1]}/bn/{m[2]}", _id),
    (r"geo_feat_generator\.(occ|level|octant)_enc\.weight",
     lambda m: f"params/geo/{m[1]}_enc/embedding", _id),
    (r"geo_feat_generator\.(mlp2|mlp3|edge_mlp1|edge_mlp2)\.(\d)\.(weight|bias)",
     lambda m: f"params/geo/{m[1]}/{_seq(m[2])}/{_WB[m[3]]}", None),
    (r"(ancient_mlp|prob_pred_mlp1|prob_pred_mlp2|pre_occ_mlp|pre_attn_mlp)"
     r"\.(\d)\.(weight|bias)",
     lambda m: f"params/{m[1]}/{_seq(m[2])}/{_WB[m[3]]}", None),
    (_BLOCK + r"layernorm_(before|after)\.(weight|bias)",
     lambda m: f"{_block(m)}/norm{'1' if m[4] == 'before' else '2'}/{_LN[m[5]]}", _id),
    (_BLOCK + r"attention\.self\.(query|key|value)\.(weight|bias)",
     lambda m: f"{_block(m)}/attn/{m[4]}/{_WB[m[5]]}", None),
    (_BLOCK + r"attention\.self\.relative_position_bias_table",
     lambda m: f"{_block(m)}/attn/rel_pos_bias", _id),
    (_BLOCK + r"attention\.output\.dense\.(weight|bias)",
     lambda m: f"{_block(m)}/attn/proj/{_WB[m[4]]}", None),
    (_BLOCK + r"intermediate\.dense\.(weight|bias)",
     lambda m: f"{_block(m)}/mlp1/{_WB[m[4]]}", None),
    (_BLOCK + r"output\.dense\.(weight|bias)",
     lambda m: f"{_block(m)}/mlp2/{_WB[m[4]]}", None),
    (_SWIN + r"downsample\.reduction\.weight",
     lambda m: f"params/swin_{m[1]}/stage_{m[2]}/merge/reduce/kernel", _t),
    (_SWIN + r"downsample\.norm\.(weight|bias)",
     lambda m: f"params/swin_{m[1]}/stage_{m[2]}/merge/norm/{_LN[m[3]]}", _id),
]

_OCTATTN_RULES = [
    (r"transformer_encoder\.layers\.(\d+)\.attn\.mlp_(query|key|value)\.(weight|bias)",
     lambda m: f"params/layer_{m[1]}/attn/{m[2]}/{_WB[m[3]]}", None),
    (r"transformer_encoder\.layers\.(\d+)\.linear([12])\.(weight|bias)",
     lambda m: f"params/layer_{m[1]}/ffn{m[2]}/{_WB[m[3]]}", None),
    (r"transformer_encoder\.layers\.(\d+)\.norm([12])\.(weight|bias)",
     lambda m: f"params/layer_{m[1]}/norm{m[2]}/{_LN[m[3]]}", _id),
    (r"(occ|level|octant)_enc\.weight", lambda m: f"params/{m[1]}_enc/embedding", _id),
    (r"(abs_pos_enc|decoder0|decoder1)\.(weight|bias)",
     lambda m: f"params/{m[1]}/{_WB[m[2]]}", None),
]

RULES = {"ehem": _EHEM_RULES, "octattention": _OCTATTN_RULES}


def _apply_rules(sd: dict, rules) -> dict:
    """state_dict (str -> array-like) -> flat {"params/...": f32 array}."""
    flat: dict[str, np.ndarray] = {}
    unmatched = []
    for key, val in sd.items():
        if any(s in key for s in _SKIP) or key in _SKIP_EXACT:
            continue
        for pat, dst, xf in rules:
            m = re.fullmatch(pat, key)
            if m:
                if xf is None:
                    xf = _t if key.endswith("weight") else _id
                flat[dst(m)] = np.asarray(xf(val), np.float32)
                break
        else:
            unmatched.append(key)
    if unmatched:
        raise ValueError(f"unmapped reference keys: {unmatched[:8]}"
                         f"{' ...' if len(unmatched) > 8 else ''}")
    return flat


def _to_tree(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def flatten(tree: dict, prefix: str = "") -> dict:
    """Nested variables -> {"params/...": array}, the npz's keys."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, path + "/"))
        else:
            out[path] = np.asarray(v)
    return out


def import_state_dict(sd: dict, model: str = "ehem") -> dict:
    """Reference state_dict (arrays or CPU tensors) -> flax variables
    {"params": ...[, "batch_stats": ...]}, nested numpy f32 dicts; Swin
    q/k/v projections come back fused (EHEM)."""
    from scp_tpu_torch.weights import fuse_qkv

    if model not in RULES:
        raise ValueError(f"model must be one of {sorted(RULES)}, got {model!r}")
    tree = _to_tree(_apply_rules(sd, RULES[model]))
    return fuse_qkv(tree) if model == "ehem" else tree


def verify_tree(variables: dict, model_name: str, model_kwargs=None, device=None):
    """Load the imported tree into the port model of `model_name` (default
    widths, or `model_kwargs`, on `device`): every parameter and buffer
    filled, every leaf used, every shape equal, or ValueError.  Returns
    the loaded model."""
    from scp_tpu_torch.models.ehem import EHEM
    from scp_tpu_torch.models.octattention import OctAttention
    from scp_tpu_torch.weights import load_into

    cls = EHEM if model_name == "ehem" else OctAttention
    model = cls(device=device, **dict(model_kwargs or {}))
    try:
        return load_into(model, variables)
    except (KeyError, ValueError) as e:
        raise ValueError(f"import mismatch: {e}") from e


def load_checkpoint(path: str, trust_pickle: bool = False) -> dict:
    """The state_dict of a reference `.ckpt` / `.pt` file as numpy arrays.
    weights_only=True first; full unpickling only with trust_pickle."""
    import torch

    try:
        blob = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # Lightning metadata outside the safe allowlist
        if not trust_pickle:
            raise SystemExit(
                f"weights_only=True load failed ({type(e).__name__}: {e}).\n"
                "Re-run with --trust_pickle ONLY if you trust this file: "
                "full unpickling executes arbitrary code from the checkpoint."
            ) from e
        blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get("state_dict", blob)
    return {k: v.numpy() if hasattr(v, "numpy") else v for k, v in sd.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True, help="reference .ckpt/.pt file")
    ap.add_argument("--model", choices=sorted(RULES), default="ehem")
    ap.add_argument("--out", required=True, help="output .npz")
    ap.add_argument("--no_verify", action="store_true",
                    help="skip the structure check (non-default model dims)")
    ap.add_argument("--trust_pickle", action="store_true",
                    help="allow full (unsafe) unpickling for checkpoints that "
                    "weights_only=True cannot load.  Published checkpoints are "
                    "untrusted public content: full unpickling executes "
                    "arbitrary code from the file; only pass this for "
                    "checkpoints you produced yourself.")
    ap.add_argument("--device", default=None,
                    help="device of the structure check's model (default cuda)")
    args = ap.parse_args(argv)

    variables = import_state_dict(load_checkpoint(args.ckpt, args.trust_pickle), args.model)
    if not args.no_verify:
        verify_tree(variables, args.model, device=args.device)
    flat = flatten(variables)
    np.savez_compressed(args.out, **flat)
    print(f"wrote {args.out}: {len(flat)} arrays "
          f"({sum(v.size for v in flat.values()):,} params)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
