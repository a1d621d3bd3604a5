"""Build everything the codec compiles, then run its phase shapes once per
cloud-size class (the twin of scp_tpu/tools/precompile.py).

    python -m scp_tpu_torch.tools.precompile --points 120000 --levels 16 \\
        --system spher [--ckpt checkpoints/ehem_synth_f16_sknn.npz] [--device cpu]

Several classes: repeat --points/--levels pairs (`--points 120000 60000
--levels 16 14`).  Runs on the card unless given `--device cpu`.

The port's persistent cache is its build directory
(`utils.env.enable_compilation_cache()`, `scp_tpu_torch/_build/`): the
six nvcc kernel libraries (`ops/_cuda.py::build_all`, on the card only)
and the g++ native library, each named by a hash of its sources.  This
tool builds whatever is missing there and says which libraries it built
cold and which it reused.  Unlike XLA's cache, a warm build directory
saves only the builds: every new process still pays PyTorch's first-call
costs (the CUDA context, cuBLAS handles, the allocator's first blocks),
which is what the seed time of the first class includes and the re-warm
time shows without.

Per class it runs `EHEMCodec.warmup` twice (one encode + decode roundtrip
in rans mode) and prints the phase-shape count, the seed time and the
re-warm time, measured in this process.  The model is the main path's
(static KNN, bf16) with the weights of `--ckpt` (default
checkpoints/ehem_synth_f16_sknn.npz, as scp_tpu's default).  The last
line is the result as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def build_libraries(device) -> dict:
    """Build (or find) every library; {"kernels": {"cold", "cached"},
    "native": "cold" | "cached", "seconds", "build_dir"}.  The kernel
    libraries need nvcc and a card: on the CPU they are not built."""
    from scp_tpu_torch.native import build as native_build
    from scp_tpu_torch.ops import _cuda
    from scp_tpu_torch.utils.env import enable_compilation_cache

    t0 = time.time()
    build_dir = enable_compilation_cache()
    kernels = None
    if device.type == "cuda":
        built = _cuda.build_all()
        kernels = {"cold": built["cold"], "cached": built["cached"]}
    native = "cached" if os.path.exists(native_build.lib_path()) else "cold"
    native_build.load_library()
    return {"kernels": kernels, "native": native, "seconds": time.time() - t0,
            "build_dir": build_dir}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, nargs="+", default=[120_000])
    ap.add_argument("--levels", type=int, nargs="+", default=[16])
    ap.add_argument("--system", default="spher", choices=["spher", "cylin", "cart"])
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--context", type=int, default=8192)
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    args = ap.parse_args(argv)
    if len(args.levels) == 1 and len(args.points) > 1:
        args.levels = args.levels * len(args.points)
    if len(args.points) != len(args.levels):
        ap.error("--points and --levels pair up")

    from scp_tpu_torch import resolve_device
    from scp_tpu_torch.codec.ehem_codec import EHEMCodec
    from scp_tpu_torch.codec.slices import split_levels
    from scp_tpu_torch.core.preprocess import kitti_qs, preprocess_points
    from scp_tpu_torch.tools.profile_codec import SKNN_CKPT, load_model
    from scp_tpu_torch.tools.train_bench_ckpt import synth_kitti

    device = resolve_device(args.device)
    libs = build_libraries(device)
    kern = ("not built on the CPU" if libs["kernels"] is None else
            f"built cold {libs['kernels']['cold']}, reused {libs['kernels']['cached']}")
    print(f"build dir {libs['build_dir']}: kernel libraries {kern}; native library "
          f"{'reused' if libs['native'] == 'cached' else 'built cold'} "
          f"({libs['seconds']:.2f} s).  A warm build directory saves the builds only: "
          "each new process still pays PyTorch's first-call costs")
    ckpt = args.ckpt or SKNN_CKPT
    codec = EHEMCodec(load_model(ckpt, device), context_size=args.context)

    rng = np.random.default_rng(0)
    angular = args.system in ("spher", "cylin")
    classes = []
    for pts_n, lvl in zip(args.points, args.levels):
        cloud = synth_kitti(rng, pts_n)
        res = preprocess_points(cloud, system=args.system, qs=kitti_qs(lvl))
        slices = split_levels(res.context, angular=angular)
        t0 = time.time()
        n_shapes = codec.warmup(slices)
        t_seed = time.time() - t0
        t0 = time.time()
        codec.warmup(slices)
        t_warm = time.time() - t0
        classes.append({"points": pts_n, "level": lvl, "system": args.system,
                        "phase_shapes": n_shapes, "seed_s": t_seed, "rewarm_s": t_warm})
        print(f"class points={pts_n} L{lvl} {args.system}: {n_shapes} phase shapes, "
              f"seed {t_seed:.2f}s, re-warm {t_warm:.2f}s (device {device}, {ckpt})")
    out = {"libraries": libs, "device": str(device), "ckpt": ckpt, "classes": classes}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
