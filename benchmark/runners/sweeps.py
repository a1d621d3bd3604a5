"""Sweeps coded end to end, closed loop, one client.

Traffic parameters (traffic/<name>.json): points per sweep, lidar_level
(the spherical KITTI rate point), sweeps and set_seed (the set of distinct
sweeps, the same for every --seed: a sweep's grid, and so its rate and its
work, follows its farthest return, so sweeps drawn per seed would make
the seed change the work), traced (passes profiled after the window in a
--trace 1 run).  The seed orders the set into a cycle; a unit of the
window is one pass over the cycle, so the window's bits and nodes are the
set's whatever its length, and every sweep is warmed in set-up.  Each
sweep goes from raw points through the program's preprocessing
(preprocess_points, split_levels), encode (EHEMCodec.encode_to_stream),
decode (new_stream_decoder + decode) and the lossless check.  One sweep of
the first pass, drawn from the seed, has its entropy model's inputs and
outputs kept (the model's public decode_phase1 / decode_phase2, wrapped on
the instance) for the comparison with the reference after the window.
"""

from __future__ import annotations

import time
from contextlib import nullcontext

import numpy as np

from benchmark.harness import products
from benchmark.harness.synth import seed_rng, synth_sweep

class Capture:
    """Keeps what the model's two phases received and returned."""

    def __init__(self, model):
        self.model = model
        self.calls = []

    def __enter__(self):
        m = self.model
        p1, p2 = m.decode_phase1, m.decode_phase2

        def phase1(data, pos):
            out = p1(data, pos)
            self.calls.append(("p1", data.detach().clone(), pos.detach().clone(),
                               out[0].detach()))
            return out

        def phase2(f1, f2, occ, trim_last):
            out = p2(f1, f2, occ, trim_last)
            self.calls.append(("p2", occ.detach().clone(), out.detach()))
            return out

        m.decode_phase1, m.decode_phase2 = phase1, phase2
        return self

    def __exit__(self, *exc):
        del self.model.decode_phase1, self.model.decode_phase2
        return False


def build_model(cfg, widths, device, params=None):
    import torch

    from scp_tpu_torch.models.ehem import EHEM
    from scp_tpu_torch.weights import load_into

    model = EHEM(token_num=widths["token_num"], max_level=widths["max_level"],
                 self_depths=tuple(widths["self_depths"]),
                 cross_depths=tuple(widths["cross_depths"]), embed_dim=widths["embed_dim"],
                 num_heads=widths["num_heads"], window_size=widths["window_size"],
                 mlp_ratio=widths["mlp_ratio"], static_knn=cfg["static_knn"],
                 pallas_knn=cfg["pallas_knn"], pallas_attn=cfg["pallas_attn"],
                 dtype=getattr(torch, cfg["dtype"]), device=device)
    return load_into(model, params if params is not None else cfg["checkpoint_path"])


def run(ctx) -> dict:
    import torch
    from torch.profiler import record_function

    from scp_tpu_torch.codec.ehem_codec import EHEMCodec
    from scp_tpu_torch.codec.slices import split_levels
    from scp_tpu_torch.core.preprocess import preprocess_points

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    widths = cfg["widths"]
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    ctx.setup_part("imports and CUDA")
    model = build_model(cfg, widths, dev, ctx.weights())
    codec = EHEMCodec(model, context_size=cfg["context_size"])
    ctx.setup_part("model")
    rng = np.random.default_rng(tr["set_seed"])
    sweeps = [synth_sweep(rng, tr["points"]) for _ in range(tr["sweeps"])]
    cycle = [sweeps[i] for i in seed_rng(ctx.seed, 0).permutation(len(sweeps))]
    sample = int(seed_rng(ctx.seed, 1).integers(len(cycle)))
    qs = 400.0 / (2 ** tr["lidar_level"] - 1)
    spans = {"preprocess": [], "encode": [], "decode": []}
    state = {"bits": 0, "points": 0, "failed": 0, "sizes": [], "codes": [], "slices": {},
             "member_sizes": {}}
    traced_ranges = [False]

    def stage_range(name):
        return record_function(f"bench.{name}") if traced_ranges[0] else nullcontext()

    def chain(member, keep, capture=None):
        pts = cycle[member]
        t0 = time.perf_counter()
        with stage_range("preprocess"):
            res = preprocess_points(pts, system="spher", qs=qs)
            sl = split_levels(res.context, angular=True)
        t1 = time.perf_counter()
        with stage_range("encode"), (capture or nullcontext()):
            stream, _, _ = codec.encode_to_stream(sl)
            sync()
        t2 = time.perf_counter()
        with stage_range("decode"):
            dec = codec.new_stream_decoder(stream, codec.ac_symbols_per_node * len(sl.occ_stream))
            codes = codec.decode(dec, sl.max_level, np.array(sl.pos_mm, np.int64),
                                 angular=sl.angular, level_sizes=sl.level_sizes)
            sync()
        if ctx.fault == "altered_symbol":  # one decoded symbol altered where it is produced
            codes = codes.copy()
            codes[len(codes) // 2] ^= 1
        t3 = time.perf_counter()
        with stage_range("check"):
            ok = codes.shape == sl.occ_stream.shape and bool((codes == sl.occ_stream).all())
        state["member_sizes"][member] = list(sl.level_sizes)
        if keep:
            spans["preprocess"].append(t1 - t0)
            spans["encode"].append(t2 - t1)
            spans["decode"].append(t3 - t2)
            state["bits"] += 8 * len(stream)
            state["points"] += len(pts)
            state["failed"] += 0 if ok else 1
            state["sizes"].append(list(sl.level_sizes))
            state["codes"].append((member, codes))
            state["slices"][member] = sl

    for j in range(len(cycle)):  # set-up: every sweep of the cycle once
        chain(j, keep=False)
    sync()
    ctx.setup_part("warm sweeps")
    ctx.setup_done()
    cap = Capture(codec.model)

    def step(i):
        for j in range(len(cycle)):
            chain(j, keep=True, capture=cap if (i, j) == (0, sample) else None)

    units, window_s = ctx.window(step)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    record = {"window_s": window_s, "units": units, "spans": spans, "chips": 1,
              "products": sweep_products(cfg, widths, state["sizes"]), "traces": None}
    if ctx.trace:
        from benchmark.harness.trace import capture

        traced_ranges[0] = True
        n = tr["traced"]
        t = capture(lambda: [chain(j % len(cycle), keep=False) for j in range(n * len(cycle))],
                    dev.index)
        record["traces"] = [t]
        record["traced_products"] = sweep_products(
            cfg, widths, [state["member_sizes"][j] for j in range(len(cycle))] * n)
    e2e = {"sweep_pts_per_s": state["points"] / window_s,
           "bpp": state["bits"] / max(state["points"], 1)}
    cap.model = None
    del codec, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    from benchmark.checks import sweeps as check

    t0 = time.perf_counter()
    checks = check.compare(ctx, cycle, qs, state, cap.calls, sample)
    return {"e2e": e2e, "record": record, "checks": checks,
            "check_s": time.perf_counter() - t0, "attempted": len(spans["encode"]),
            "failed": state["failed"], "memory_peak_bytes": peak}


def sweep_products(cfg, widths, sizes_per_sweep) -> dict:
    """Forward products of the window's sweeps (encode and decode each run
    both phases once per window of real nodes) and the kernels' work."""
    from benchmark.reference.octree import TINY_LEVEL, level_windows

    flops = 0
    swin, knn = [], []
    for sizes in sizes_per_sweep:
        for n in sizes:
            if n <= TINY_LEVEL:
                continue
            for _, m, w in level_windows(n, cfg["context_size"]):
                flops += 2 * products.total(products.window_products(widths, cfg["static_knn"], m))
                swin += 2 * products.swin_kernel_work(widths, m, w)
                if cfg["pallas_knn"]:
                    knn += 2 * products.knn_kernel_work(cfg["static_knn"], m, w)
    return {"flops": flops, "swin": swin, "knn": knn}
