"""Shared building blocks of the entropy models (port of
scp_tpu/models/layers.py).

Weights follow `nn.Linear`'s layout, (out, in).  Every parameter is a
float32 master, as flax keeps them, and is cast to the model's compute
dtype where the JAX package casts it (a flax Dense with dtype bf16 casts
its kernel and bias to bf16 at use; the fused sublayers take the cast
kernels and the float32 biases).  An Adam step of 1e-4 moves an f32
master; it would round away on a bf16 weight near 1 (ulp 2^-7).  The
rounding of an f32 master to bf16 is the one the codec always used, so
its numbers do not move.

`flax_init_` draws fresh parameters with flax's default initializers.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def sinusoidal_position_table(max_len: int, d_model: int) -> np.ndarray:
    """Classic sin/cos table (reference attention_model.py:6-22)."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(
        np.arange(0, d_model, 2, dtype=np.float32) * (-np.log(10000.0) / d_model)
    )
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


def nearest_up(x: torch.Tensor, factor: int, length: int) -> torch.Tensor:
    """Nearest-repeat upsample along axis 1 and truncate to `length`
    (index i -> i // factor; the reference's repeated x2 climb)."""
    if factor == 1:
        return x[:, :length]
    return torch.repeat_interleave(x, factor, dim=1)[:, :length]


class Dense(nn.Module):
    """flax `nn.Dense` with a compute dtype: y = x W^T + b in `dtype`, from
    an f32 master weight and bias."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def kernel(self) -> torch.Tensor:
        """The weight in the compute dtype (the cast stays on the gradient path)."""
        return self.weight.to(self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.kernel(), b)

    def flops(self, rows: int) -> int:
        """Products of the forward over `rows` rows, 2 per multiply-add."""
        out_f, in_f = self.weight.shape
        return 2 * rows * in_f * out_f


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm(dtype=float32)`: statistics and output in f32."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias, self.eps)


class MLP(nn.Module):
    """Linear stack with LeakyReLU(0.01) between layers (EHEM's MLP idiom)."""

    def __init__(self, in_features: int, features: Sequence[int],
                 dtype: torch.dtype = torch.float32, negative_slope: float = 0.01):
        super().__init__()
        self.negative_slope = negative_slope
        self.dtype = dtype
        self.names = []
        prev = in_features
        for i, f in enumerate(features):
            self.add_module(f"dense_{i}", Dense(prev, f, dtype=dtype))
            self.names.append(f"dense_{i}")
            prev = f

    def _layers(self):
        return [getattr(self, n) for n in self.names]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layers = self._layers()
        for i, layer in enumerate(layers):
            x = layer(x)
            if i < len(layers) - 1:
                x = F.leaky_relu(x, self.negative_slope)
        return x

    def flops(self, rows: int) -> int:
        return sum(layer.flops(rows) for layer in self._layers())

    def multiscale(self, pyramid: Sequence[torch.Tensor], extra=None) -> torch.Tensor:
        """The stack applied to concat([up(p) for p in pyramid] + [extra])
        without materializing the concat: the first Dense is split into
        row blocks of its kernel, each stage is projected at its own
        resolution and the projections are upsampled and summed (same
        function as scp_tpu's MLP.multiscale, layers.py:57)."""
        full_len = pyramid[0].shape[1]
        layers = self._layers()
        d0 = layers[0]
        kernel = d0.kernel()  # (out, in): the row blocks of flax's kernel are column blocks here
        off = 0
        acc = None
        for i, p in enumerate(pyramid):
            c = p.shape[-1]
            y = F.linear(p.to(self.dtype), kernel[:, off : off + c])
            off += c
            y = nearest_up(y, 1 << i, full_len)
            acc = y if acc is None else acc + y
        if extra is not None:
            c = extra.shape[-1]
            acc = acc + F.linear(extra.to(self.dtype), kernel[:, off : off + c])
            off += c
        if off != kernel.shape[1]:
            raise ValueError(f"multiscale widths {off} != kernel rows {kernel.shape[1]}")
        x = acc + d0.bias.to(self.dtype)
        for layer in layers[1:]:
            x = F.leaky_relu(x, self.negative_slope)
            x = layer(x)
        return x

    def multiscale_flops(self, batch: int, pyramid, extra_width: int = 0) -> int:
        """Products of `multiscale` over a pyramid [(rows per batch, width)]
        and an extra of `extra_width` at full length: the first Dense's row
        blocks at each level's own length, the rest at full length."""
        full = pyramid[0][0]
        out0 = self.dense_0.weight.shape[0]
        f = sum(2 * batch * n * c * out0 for n, c in pyramid)
        f += 2 * batch * full * extra_width * out0
        return f + sum(layer.flops(batch * full) for layer in self._layers()[1:])


@torch.no_grad()
def flax_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fresh parameters by flax's default initializers: Dense kernels
    lecun_normal (truncated normal, std sqrt(1/fan_in) / .8796), Dense
    biases and relative-position tables 0, embeddings normal with std
    sqrt(1/features), norms scale 1 and bias 0, BatchNorm statistics
    mean 0 and var 1.  Draws in module order from `generator` (on the CPU,
    so a seed gives the same weights on every device)."""

    def draw(shape, std, truncated):
        t = torch.randn(shape, generator=generator)
        if truncated:  # resample outside 2 std, as jax.random.truncated_normal bounds it
            bad = t.abs() > 2
            while bad.any():
                t[bad] = torch.randn(int(bad.sum()), generator=generator)
                bad = t.abs() > 2
        return t * std

    for mod in model.modules():
        if isinstance(mod, Dense):
            fan_in = mod.weight.shape[1]
            mod.weight.copy_(draw(mod.weight.shape, math.sqrt(1.0 / fan_in) / .87962566103423978,
                                  True))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.copy_(draw(mod.weight.shape, math.sqrt(1.0 / mod.weight.shape[1]), False))
        elif isinstance(mod, LayerNorm) or hasattr(mod, "running_var"):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if hasattr(mod, "running_var"):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        elif hasattr(mod, "rel_pos_bias"):
            mod.rel_pos_bias.zero_()
    return model
