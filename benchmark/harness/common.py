"""What every run shares: the device check, the caches inside the
checkout, the whole-unit window, percentiles, the forbidden modules and
the result line."""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "scp_tpu")


def forbidden_loaded(modules=None) -> list:
    """Top-level names in `modules` (sys.modules) that are JAX or the JAX
    package, compared whole: scp_tpu_torch is not scp_tpu."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(n for n in names if n in FORBIDDEN)


def set_cache_dirs(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's nvcc and g++ libraries already build into
    scp_tpu_torch/_build/ there)."""
    base = os.path.join(root, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def check_devices(chips: int) -> str | None:
    """None when `chips` CUDA cards are visible, else the reason."""
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return f"{torch.cuda.device_count()} CUDA cards visible, the cell needs {chips}"
    return None


def card_line() -> str:
    """nvidia-smi's name and power limit of the cards, or why not."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def whole_units(step, seconds: float, clock=time.perf_counter) -> tuple[int, float]:
    """Run `step(i)` for whole units: none begins after `seconds`, and the
    window ends when the last one begun has completed (each `step` returns
    only when its work is done).  Returns (units, window seconds)."""
    t0 = clock()
    i = 0
    while clock() - t0 < seconds:
        step(i)
        i += 1
    return i, clock() - t0


def p50(values) -> float | None:
    return float(statistics.median(values)) if values else None


def finite(x) -> bool:
    return x is not None and isinstance(x, (int, float)) and math.isfinite(x)


def passes(checks) -> bool:
    """Every number compared present, finite and within its limit."""
    return all(finite(v) and v <= lim for _, v, lim in checks)


def metric(value, unit: str) -> dict:
    return {"value": value, "unit": unit}


def print_limits(checks: list) -> None:
    """Each number compared beside its limit, as the last lines on stderr."""
    for name, value, limit in checks:
        print(f"check {name}: {value!r} limit {limit!r}", file=sys.stderr, flush=True)


def result_line(correct, attempted, failed, metrics, device, checks, breakdown=None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return json.dumps(out)
