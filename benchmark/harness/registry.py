"""Lookup by name of everything a cell is made of.

A cell of BENCHMARK.json names a configuration and a traffic mix; each is
a file of its own (configs/<name>.json, traffic/<name>.json), a per-layer
metric is a reader metrics/<name>.py, a kernel family is a name map
kernels/<family>.json and a cell's correctness limits are
limits/<cell>.json.  A later change adds a cell by adding files only.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(*parts) -> dict:
    path = os.path.join(BENCH_DIR, *parts)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {os.path.relpath(path, ROOT)}")
    with open(path) as fh:
        return json.load(fh)


def benchmark_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"({', '.join(w['name'] for w in spec['workloads'])})")


def config(name: str) -> dict:
    return _json("configs", f"{name}.json")


def traffic(name: str) -> dict:
    return _json("traffic", f"{name}.json")


def limits(cell: str) -> dict:
    return _json("limits", f"{cell}.json")


def kernel_map(family: str) -> dict:
    return _json("kernels", f"{family}.json")


def runner(kind: str):
    return importlib.import_module(f"benchmark.runners.{kind}")


def metric_reader(name: str):
    """The `read(record)` function of metrics/<name>.py (names may hold dots)."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no reader benchmark/metrics/{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(spec: dict, cell: str, kind: str) -> list:
    """The `end_to_end` or `per_layer` metrics that `cell` reports: those
    that list it under `workloads`, and those that list no cells."""
    return [m for m in spec[kind] if "workloads" not in m or cell in m["workloads"]]
