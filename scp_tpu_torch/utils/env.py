"""The port's environment helpers (the twin of scp_tpu/utils/env.py).

scp_tpu's two functions switch JAX's persistent compilation cache on and
force its CPU platform with virtual host devices.  The port has no
compiler cache to switch on and no platform to force, so each function
keeps its name with the port's meaning and sets no environment variable:

  * `enable_compilation_cache()` is the directory where the port's
    compiled artefacts persist, named by a hash of their sources: the
    nvcc libraries of ops/_cuda.py and the g++ library of
    native/build.py, both in `scp_tpu_torch/_build/`.  A later process
    reuses what is there and builds only what changed.  PyTorch's own
    first-call costs (the CUDA context, cuBLAS handles, the caching
    allocator) are not cached by anything and are paid by every process.
  * `force_cpu(virtual_devices=None)` is the CPU device, or a list of that
    many CPU devices for `EHEMCodec(model, devices=...)`: the port's
    stand-in for JAX's virtual host devices, whose lane shards then run
    one after another on the host.  It hides no card from anything else.
"""

from __future__ import annotations

import os


def enable_compilation_cache() -> str:
    """Create and return the build directory that ops/_cuda.py and
    native/build.py share."""
    from scp_tpu_torch.ops import _cuda

    os.makedirs(_cuda.BUILD_DIR, exist_ok=True)
    return _cuda.BUILD_DIR


def force_cpu(virtual_devices: int | None = None):
    """`torch.device("cpu")`, or a list of `virtual_devices` of them (the
    lane shards of a sharded codec on the host)."""
    import torch

    cpu = torch.device("cpu")
    if virtual_devices is None:
        return cpu
    if int(virtual_devices) < 1:
        raise ValueError(f"virtual_devices must be at least 1, got {virtual_devices}")
    return [cpu] * int(virtual_devices)
