"""The backward pass the kernel seams share.

scp_tpu wraps each Pallas kernel (A, B, C, E) in a `jax.custom_vjp` whose
forward is the kernel and whose backward is `jax.vjp` of the plain XLA
reference, recomputed from the saved inputs (pallas_mlp.py:153-175,
pallas_swin.py:338-390, pallas_attn.py:86-103).  The port's counterparts
are `torch.autograd.Function`s that save their tensor inputs and call
`plain_vjp` in their backward: autograd of the plain version on detached
copies of those inputs.
"""

from __future__ import annotations

import torch


def plain_vjp(plain, ctx, grad, *consts):
    """Gradients of `plain(*saved, *consts)` against `grad`, one per saved
    tensor (None where the input needs none or is None, e.g. the mask).

    The saved tensors are the Function's leading arguments, in order."""
    saved = ctx.saved_tensors
    need = ctx.needs_input_grad[: len(saved)]
    with torch.enable_grad():
        inputs = [None if t is None else t.detach().requires_grad_(bool(n))
                  for t, n in zip(saved, need)]
        wrt = [t for t in inputs if t is not None and t.requires_grad]
        got = iter(torch.autograd.grad(plain(*inputs, *consts), wrt, grad) if wrt else ())
    return tuple(next(got) if t is not None and t.requires_grad else None for t in inputs)
