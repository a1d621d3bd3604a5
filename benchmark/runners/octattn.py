"""OctAttention sweeps coded end to end, closed loop, one client.

Traffic parameters (traffic/<name>.json): points per sweep, lidar_level
(the spherical KITTI rate point) and set_seed (the sweep: the first of the
sweeps traffic's generator, as float32, as a KITTI .bin holds it; the same
for every --seed, since a sweep's grid and so its work follow its farthest
return); warm_points / warm_level (the smaller sweep set-up codes to warm
the path, after preprocessing the sweep once).  A unit is the sweep through
the program's normal path: preprocess_points, the fused device-rANS encode
(OctAttentionCodec.encode_incremental_into + finish), the stream decoder
(decode_incremental_rans) and the lossless check.  Set-up also meets
every shape of the sweep's level loops that the warm sweep leaves unmet
(level_shapes), so that no first use of one (a cuBLAS heuristic, a lazily
loaded kernel) falls inside the window.  The window runs under
the program's span recording, one unit per sweep.  In the first unit the
decoder's model steps are kept (the public decode_step, wrapped on the
instance): every position's logits, and the inputs of one level drawn
from the seed, for the comparison with the reference after the window.
A --trace 1 run then codes the deepest level's encode loop twice, once
under recording alone (its pace) and once under the device trace (its
launches and idle share).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from benchmark.harness import octattn as products
from benchmark.harness.synth import seed_rng, synth_sweep


class StepCapture:
    """Keeps what the model's decode_step received and returned: every
    position's logits, and the inputs of level `keep_level`."""

    def __init__(self, model, keep_level: int):
        self.model, self.keep_level = model, keep_level
        self.level = -1
        self.logits = []  # [level][position] (lanes, 255)
        self.inputs = []  # [position] (data (lanes, K, 3), pos (lanes, K, 3)) of keep_level

    def __enter__(self):
        step = self.model.decode_step

        def decode_step(data_t, pos_t, cache, length):
            if length == 0:
                self.level += 1
                self.logits.append([])
            out = step(data_t, pos_t, cache, length)
            self.logits[-1].append(out[0])
            if self.level == self.keep_level:
                self.inputs.append((data_t.detach().clone(), pos_t.detach().clone()))
            return out

        self.model.decode_step = decode_step
        return self

    def __exit__(self, *exc):
        del self.model.decode_step
        return False


def program_model(ctx, device):
    """The program's model: models.build_model on the configuration's widths,
    in its dtype, with the checkpoint (a rehearsal: fresh weights from the
    seed)."""
    import torch

    from scp_tpu_torch.config import load_config
    from scp_tpu_torch.models import build_model
    from scp_tpu_torch.weights import load_into

    cfg = ctx.config
    run_cfg = load_config("train_kitti.yaml", config_dir=os.path.join(ctx.root, "configs"))
    for key, value in cfg["widths"].items():
        run_cfg.model[key] = value
    model = build_model(run_cfg, getattr(torch, cfg["dtype"]), device=device)
    return load_into(model, products.nested(reference_params(ctx, "cpu")) if ctx.rehearse
                     else cfg["checkpoint_path"])


def plant(fault, model):
    """Faults planted under the timed path, for the fault tests only."""
    if fault in (None, "altered_symbol"):
        return
    if fault != "perturbed_cache_row":
        raise ValueError(f"unknown fault {fault!r}")
    insert = model.decode_insert

    def decode_insert(data_t, pos_t, cache, length, qs):
        # one cached key row of every level shifted, alike in both
        # directions: the stream still decodes, the probabilities are wrong
        out = insert(data_t, pos_t, cache, length, qs)
        if length == 0:
            cache["k"][0, :, :, 0] += 0.5
        return out

    model.decode_insert = decode_insert


def reference_params(ctx, device):
    """The reference's flat weights: the checkpoint's, or in a rehearsal
    fresh ones from the seed (which the program is given too)."""
    import torch

    from benchmark.reference.octattention import fresh_params, load_params

    if ctx.rehearse:
        gen = torch.Generator().manual_seed(int(ctx.seed) % (1 << 63))
        fresh = fresh_params(ctx.config["widths"], gen, "cpu")
        return {k: v.to(device) for k, v in fresh.items()}
    return load_params(ctx.config["checkpoint_path"], device)


def run(ctx) -> dict:
    import torch

    from scp_tpu_torch.codec.octattn_codec import OctAttentionCodec
    from scp_tpu_torch.core.preprocess import kitti_qs, preprocess_points
    from scp_tpu_torch.utils import profiling

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    widths = cfg["widths"]
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    ctx.setup_part("imports and CUDA")
    model = program_model(ctx, dev)
    plant(ctx.fault, model)
    codec = OctAttentionCodec(model, mode=cfg["coder"], fused=cfg["fused"])
    ctx.setup_part("model")
    sweep = synth_sweep(np.random.default_rng(tr["set_seed"]), tr["points"]).astype(np.float32)
    warm = synth_sweep(np.random.default_rng([tr["set_seed"], 1]),
                       tr["warm_points"]).astype(np.float32)
    spans = {"preprocess": [], "encode": [], "decode": []}
    state = {"bits": 0, "points": 0, "failed": 0, "codes": [], "rows": None, "sizes": None}
    keep = {"capture": None}

    def chain(pts, level, keep_unit):
        t0 = time.perf_counter()
        rows = preprocess_points(pts, system="spher", qs=kitti_qs(level)).context
        t1 = time.perf_counter()
        enc = codec.new_rans_encoder(codec.max_lane_bucket(rows))
        codec.encode_incremental_into(enc, rows)
        payload = enc.finish()
        t2 = time.perf_counter()
        max_level = int(rows[:, -1, 1].max())  # the stream header's
        cap = None
        if keep_unit and keep["capture"] is None:  # the window's first unit
            cap = keep["capture"] = StepCapture(
                model, int(seed_rng(ctx.seed, 1).integers(max_level)))
        dec = codec.new_rans_decoder(payload)
        if cap is not None:
            with cap:
                codes = codec.decode_incremental_rans(dec, max_level)
        else:
            codes = codec.decode_incremental_rans(dec, max_level)
        sync()
        if ctx.fault == "altered_symbol":  # one decoded symbol altered where it is produced
            codes = codes.copy()
            codes[len(codes) // 2] ^= 1
        t3 = time.perf_counter()
        levels, occ, _ = codec.split_levels(rows)
        ok = codes.shape == occ.shape and bool((codes == occ).all())
        if keep_unit:
            spans["preprocess"].append(t1 - t0)
            spans["encode"].append(t2 - t1)
            spans["decode"].append(t3 - t2)
            state["bits"] += 8 * len(payload)
            state["points"] += len(pts)
            state["failed"] += 0 if ok else 1
            state["codes"].append(codes)
            state["rows"], state["sizes"] = rows, [d.shape[0] for d, _ in levels]

    # set-up: the sweep's preprocessing (its octree is the native builder's,
    # which builds at first use), every part of the path on the warm sweep,
    # then every shape of the sweep's level loops
    rows = preprocess_points(sweep, system="spher", qs=kitti_qs(tr["lidar_level"])).context
    ctx.setup_part("preprocessing")
    chain(warm, tr["warm_level"], keep_unit=False)
    sync()
    ctx.setup_part("warm sweep")
    level_shapes(codec, rows, sync)
    ctx.setup_part("level shapes")
    ctx.setup_done()

    def step(i):
        with profiling.unit(i):
            chain(sweep, tr["lidar_level"], keep_unit=True)

    with profiling.recording():
        units, window_s = ctx.window(step)
    program = profiling.drain()
    print("benchmark: units s " + " ".join(
        f"{a + b + c:.3f}" for a, b, c in zip(*spans.values())), file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    csz = widths["context_size"]
    flops = 2 * units * sum(products.level_products(widths, n, csz) for n in state["sizes"])
    record = {"window_s": window_s, "units": units, "spans": spans, "chips": 1,
              "products": {"flops": flops}, "program": program, "probe": None, "traces": None}
    if ctx.trace:
        record["probe"], record["traces"] = deepest_level(codec, state["rows"], sync, dev)
    e2e = {"sweep_pts_per_s": state["points"] / window_s,
           "bpp": state["bits"] / max(state["points"], 1)}
    from benchmark.checks import octattn as check

    t0 = time.perf_counter()
    checks = check.compare(ctx, sweep, state, keep["capture"], reference_params(ctx, dev))
    return {"e2e": e2e, "record": record, "checks": checks,
            "check_s": time.perf_counter() - t0, "attempted": units,
            "failed": state["failed"], "memory_peak_bytes": peak}


def level_shapes(codec, rows, sync):
    """Meet every shape of the sweep's level loops without coding them.  Per
    lane count, the largest such level's first position (the shapes that
    follow the lanes alone), then the cached attention at every cache length
    that level reaches: its batched products take a shape per length.  The
    decoder's steps add a few shapes that follow the lanes alone."""
    import torch

    levels, _, _ = codec.split_levels(rows)
    largest = {}
    for li, (data, _) in enumerate(levels):
        n = data.shape[0]
        lanes = codec._lane_count(-(-n // codec.csz))
        if n > largest.get(lanes, (0, None))[0]:
            largest[lanes] = (n, li)
    model = codec.model
    layer = model.layers[0]
    for lanes, (n, li) in sorted(largest.items()):
        level_loop(codec, rows, li, sync, positions=1)()
        cache = model.init_cache(lanes)
        x = torch.zeros((lanes, layer.d_model), dtype=model.dtype, device=codec.device)
        with torch.no_grad():
            for length in range(1, min(codec.csz, n)):
                layer._attend_cached(x, x, x, cache["k"][0], cache["v"][0], length)
    sync()


def level_loop(codec, rows, li, sync, positions=None):
    """A callable that runs level `li`'s encode loop (teacher-forced, the
    device rANS rows of every position; of its first `positions` only, if
    given) and synchronises."""
    levels, occ, max_level = codec.split_levels(rows)
    n = levels[li][0].shape[0]
    lanes = codec._lane_count(-(-n // codec.csz))
    pos_int = rows[rows[:, -1, 1] == li + 1][:, :, 3:6].astype(np.int32)
    inputs = codec._fused_inputs(*codec._level_bufs(levels[li][0], pos_int, lanes),
                                 float(np.float32(1.0 / float(2 ** max_level))), lanes)
    first = sum(d.shape[0] for d, _ in levels[:li])
    true_syms = codec._true_syms(occ[first:first + n].astype(np.int64), n, lanes)

    def loop():
        # n = positions: the loop steps min(context, n) positions
        codec._rans_level(inputs, positions or n, lanes, true_syms=true_syms)
        sync()

    return loop


def deepest_level(codec, rows, sync, dev):
    """The encode loop of the sweep's deepest level: once under the
    program's recording (unit "deepest"), once more under the device trace
    as well (unit "traced").  Returns (the drained recording, [trace])."""
    from scp_tpu_torch.utils import profiling

    from benchmark.harness.trace import capture

    loop = level_loop(codec, rows, len(codec.split_levels(rows)[0]) - 1, sync)
    sync()
    with profiling.recording():
        with profiling.unit("deepest"):
            loop()
        with profiling.unit("traced"):
            trace = capture(loop, dev.index)
    return profiling.drain(), [trace]
