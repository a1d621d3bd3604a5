"""The benchmark of scp_tpu_torch on NVIDIA H100s.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell (BENCHMARK.json's `workloads`)
names a configuration (benchmark/configs/<name>.json) and a traffic mix
(benchmark/traffic/<name>.json), whose `runner` runs it: set-up (weights,
inputs from the seed, every shape warmed), then whole units of work for
`--seconds`, then the comparison with the plain reference that decides
`correct`.  With --trace 0 the result carries the cell's end-to-end
metrics, with --trace 1 its per-layer metrics (benchmark/metrics/<name>.py
readers) from the same window and a device trace of a few more units.

Exits 2, printing no result, without as many CUDA cards as the cell asks
for, and 3 when JAX or the JAX package is loaded once the window has
closed.  The last stderr lines give each number compared beside its limit;
the last stdout line is the result.

`--rehearse` runs the same path on the CPU at the configuration's and the
traffic's `rehearsal` sizes (narrow widths, fresh weights from the seed,
small sweeps) for the tests; its result says platform "cpu".
"""

from __future__ import annotations

import time

T0 = time.perf_counter()
T0_WALL = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


class Context:
    """What a runner is given: the cell, its files, the seed and window,
    the device, the weights, and the set-up clock."""

    def __init__(self, args, cell, config, traffic):
        import torch

        self.cell, self.seed, self.seconds, self.trace = cell["name"], args.seed, args.seconds, \
            bool(args.trace)
        self.chips = int(cell["chips"])
        self.rehearse = bool(args.rehearse)
        self.config = dict(config, **config.get("rehearsal", {})) if self.rehearse else config
        self.traffic = dict(traffic, **traffic.get("rehearsal", {})) if self.rehearse else traffic
        self.config["checkpoint_path"] = os.path.join(ROOT, self.config["checkpoint"])
        self.device = torch.device("cpu" if self.rehearse else "cuda:0")
        self.root = ROOT
        self.control, self.fault = bool(args.control), args.fault
        self.t0_wall = T0_WALL
        self.setup_s = None
        self.parts = []

    def setup_part(self, name):
        """Mark the end of one part of set-up (printed beside setup_s)."""
        self.parts.append((name, time.perf_counter() - T0))

    def setup_done(self):
        self.setup_s = time.perf_counter() - T0

    def window(self, step):
        from benchmark.harness.common import whole_units

        return whole_units(step, self.seconds)

    def _fresh(self, device):
        import torch

        from benchmark.reference.ehem import fresh_params

        gen = torch.Generator(device=device).manual_seed(int(self.seed) % (1 << 63))
        return fresh_params(self.config["widths"], gen, device)

    def weights(self):
        """The program's weights: None (its configuration's checkpoint), or
        in a rehearsal fresh ones from the seed as nested flax variables."""
        if not self.rehearse:
            return None
        params, stats = self._fresh("cpu")
        nested = {}
        for coll, flat in (("params", params), ("batch_stats", stats)):
            for path, t in flat.items():
                node = nested.setdefault(coll, {})
                *scope, leaf = path.split("/")
                for s in scope:
                    node = node.setdefault(s, {})
                node[leaf] = t.numpy()
        return nested

    def limits(self) -> dict:
        """The cell's limits (limits/<cell>.json); a rehearsal's, set from
        readings at its own narrow size, where the file has them."""
        from benchmark.harness import registry

        lim = registry.limits(self.cell)
        return dict(lim, **lim.get("rehearsal", {})) if self.rehearse else lim

    def weights_file(self, out_dir):
        """A flax `.npz` of the program's weights: the configuration's
        checkpoint, or in a rehearsal the fresh ones written to `out_dir`."""
        if not self.rehearse:
            return self.config["checkpoint_path"]
        import numpy as np

        params, stats = self._fresh("cpu")
        path = os.path.join(out_dir, "fresh_weights.npz")
        np.savez(path, **{f"params/{k}": v.numpy() for k, v in params.items()},
                 **{f"batch_stats/{k}": v.numpy() for k, v in stats.items()})
        return path

    def reference_weights(self, device):
        """The reference's (params, stats), read by its own loader."""
        if self.rehearse:
            params, stats = self._fresh("cpu")
            return ({k: v.to(device) for k, v in params.items()},
                    {k: v.to(device) for k, v in stats.items()})
        from benchmark.reference.ehem import load_params

        return load_params(self.config["checkpoint_path"], device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true", help=argparse.SUPPRESS)
    # readings for the limits, never passed by a check: the reference in the
    # configuration's next lower precision in the program's place (--control),
    # or a fault planted under the timed path (--fault)
    ap.add_argument("--control", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--fault", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from benchmark.harness import common, registry

    spec = registry.benchmark_spec(ROOT)
    cell = registry.workload(spec, args.workload)
    config, traffic = registry.config(cell["config"]), registry.traffic(cell["traffic"])
    common.set_cache_dirs(ROOT)
    if not args.rehearse:
        why = common.check_devices(int(cell["chips"]))
        if why:
            print(f"benchmark: {why}; no result", file=sys.stderr)
            return 2
    ctx = Context(args, cell, config, traffic)
    out = registry.runner(ctx.traffic["runner"]).run(ctx)

    rec = out["record"]
    parts = ", ".join(f"{n} to {t:.3f}" for n, t in ctx.parts)
    print(f"benchmark: setup_s {ctx.setup_s:.3f} ({parts}) window_s {rec['window_s']:.3f} "
          f"units {rec['units']} reference check s {out['check_s']:.3f}", file=sys.stderr)
    if args.trace:
        metrics = {}
        for m in registry.metrics_of(spec, cell["name"], "per_layer"):
            value = registry.metric_reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = common.metric(value, m["unit"])
    else:
        values = dict(out["e2e"], setup_s=ctx.setup_s)
        metrics = {m["name"]: common.metric(values[m["name"]], m["unit"])
                   for m in registry.metrics_of(spec, cell["name"], "end_to_end")}
    bad = common.forbidden_loaded()
    if bad:
        print(f"benchmark: {', '.join(bad)} loaded in the process that reports; no result",
              file=sys.stderr)
        return 3
    if ctx.rehearse:
        device = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    else:
        import torch

        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": ctx.chips, "memory_peak_bytes": int(out["memory_peak_bytes"])}
        print(f"benchmark: {common.card_line()}", file=sys.stderr)
    breakdown = None
    if args.trace and rec.get("traces"):
        from benchmark.harness.trace import breakdown as reduce_breakdown

        traces = rec["traces"]
        device["busy_s"] = sum(t.busy_s for t in traces) / len(traces)
        device["window_s"] = sum(t.window_s for t in traces) / len(traces)
        breakdown = reduce_breakdown(traces)
    checks = out["checks"]
    correct = common.passes(checks) and out["failed"] == 0
    common.print_limits(checks)
    print(common.result_line(correct, out["attempted"], out["failed"], metrics, device, checks,
                             breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
