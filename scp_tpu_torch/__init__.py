"""scp_tpu_torch — the PyTorch/CUDA port of scp_tpu for one NVIDIA H100.

The JAX package `scp_tpu` is the reference; this package imports nothing
of it (nor JAX), keeping its own copies of the numpy host modules.  Its
subpackages mirror scp_tpu's:

  core    — numpy geometry: Morton codes, octree, transforms, quantization.
  codec   — level slicing, stream container, device rANS, the EHEM codec
            (rans, staged and full modes; codec/staged.py), OctAttention's.
  models  — torch EHEM: DGCNN trunk, 1-D Swin, multiscale heads.
  ops     — KNN, the fused KNN distance + top-k, the fused Swin
            sublayers and window attention, with their Hopper kernels
            (CUDA C++ under ops/csrc, built with nvcc at first use), and
            the autograd Functions that give the kernels scp_tpu's
            custom_vjp backward.
  train   — the single-device trainer of EHEM and OctAttention: data
            pipeline, loss, Adam + StepLR, OctAttention's dropout masks,
            checkpoints (and scp_tpu's npz format).
  config  — the YAML config system, read without PyYAML.
  metrics — D1/D2 PSNR and Chamfer (the native KD-tree; scipy's with
            native=False).
  native  — the C++ octree builder, range coder and KD-tree metrics,
            built with g++ at first use and loaded with ctypes.
  cli     — the codec CLIs (encode, decode, selftest; EHEM in its three
            coding modes, OctAttention in its three schedules) and the
            training CLI.
  tools   — the test-data and shard CLIs (test_gene, psnr_test,
            preprocess, multi_preproc, gene_normals), the port bench
            (single-scan throughput on the card), the bench-checkpoint
            recipe, the reference-checkpoint importer, precompile,
            profiles (MFU among them), probes, the scaling curve.
  utils   — spans, counters and stage timers (profiling); the build
            directory and CPU devices (env).

Entry points run on `cuda` unless the caller passes `device="cpu"`; with
no card and no such argument they raise instead of falling back.

Importing the package does not import torch, so the host-only tools
(tools.preprocess, spawned once per part by tools.multi_preproc) start
without it.
"""

from __future__ import annotations

__version__ = "0.1.0"


def resolve_device(device=None) -> "torch.device":  # noqa: F821
    """The device an entry point runs on: `cuda` unless told otherwise.

    Raises when CUDA is asked for (explicitly or by default) and there is
    no card — the port never falls back to the CPU on its own."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "scp_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev
