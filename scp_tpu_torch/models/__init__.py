"""Torch entropy models of the port: EHEM and OctAttention (codec
inference and training), built from a run config by
`build_model` (scp_tpu's registry, scp_tpu/models/__init__.py)."""

from __future__ import annotations


def get_model_class(name: str):
    from scp_tpu_torch.models.ehem import EHEM
    from scp_tpu_torch.models.octattention import OctAttention

    registry = {"OctAttention": OctAttention, "EHEM": EHEM,
                # checkpoint-compat alias (the reference's encode.py:249 accepts it)
                "EHEMVoxel": EHEM}
    if name not in registry:
        raise KeyError(f"unknown model {name!r}; known: {sorted(registry)}")
    return registry[name]


def build_model(cfg, dtype=None, device=None, **switches):
    """The model of `cfg.model.class_name` in compute dtype `dtype` (f32 by
    default).  `switches` are EHEM's constructor switches (static_knn,
    pallas_knn, pallas_attn, ...); OctAttention takes none."""
    import torch

    cls = get_model_class(str(cfg.model.class_name))
    if switches and cls.__name__ != "EHEM":
        raise ValueError(f"{cls.__name__} takes none of EHEM's switches, got "
                         + ", ".join(f"{k}={v}" for k, v in sorted(switches.items())))
    return cls.from_config(cfg, dtype or torch.float32, device=device, **switches)
