"""Where the time of the port's main path goes, on the card.

    python3 profile_port.py [--out chiprun_out/profile_port.json]
    python3 profile_port.py --pallas

Runs chip_smoke.py's L16 roundtrip (the 120,000-point cloud, seed 0, the
full-width EHEM from ehem_synth_f16_sknn.npz): one cold pass, two warm
passes timed on the host clock, then one warm pass under torch.profiler.
The profiled pass wraps the codec's layers in named ranges (phase 1,
phase 2, the rANS chunks, the expansion, the KNN) and sums device time by
kernel.  --pallas profiles chip_smoke.py's phase-5 configuration instead
(pallas_knn and pallas_attn on: kernels D and E), with the same ranges,
and by default writes profile_port_pallas.json beside the default file.
Prints a summary and writes it as JSON to --out.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from chip_smoke import CKPT, LIDAR_LEVEL, N_POINTS, synth_kitti


def _wrap(owner, name, label):
    fn = getattr(owner, name)

    @functools.wraps(fn)  # keeps a kernel wrapper's launch count attribute
    def wrapped(*a, **k):
        with record_function(label):
            return fn(*a, **k)

    setattr(owner, name, wrapped)


def roundtrip(codec, slices):
    torch.cuda.synchronize()
    t0 = time.time()
    stream, bits, _ = codec.encode_to_stream(slices)
    torch.cuda.synchronize()
    t_enc = time.time() - t0
    t0 = time.time()
    codes = codec.decode(codec.new_stream_decoder(stream, len(slices.occ_stream),
                                                 coding_params=codec.coding_params()),
                         slices.max_level,
                         np.array(slices.pos_mm, np.int64), angular=True,
                         ground_truth=slices.occ_stream, level_sizes=slices.level_sizes)
    torch.cuda.synchronize()
    t_dec = time.time() - t0
    assert (codes == slices.occ_stream).all()
    return t_enc, t_dec, bits


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pallas", action="store_true",
                    help="pallas_knn and pallas_attn on (chip_smoke.py's phase 5)")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "profile_port.json"))
    args = ap.parse_args()
    out_path = args.out
    if args.pallas and out_path == ap.get_default("out"):
        out_path = out_path.replace(".json", "_pallas.json")
    if not torch.cuda.is_available():
        raise SystemExit("profile_port.py measures the card; no CUDA device available")

    from scp_tpu_torch.codec import ehem_codec, rans
    from scp_tpu_torch.codec.slices import split_levels
    from scp_tpu_torch.core.preprocess import kitti_qs, preprocess_points
    from scp_tpu_torch.models import dgcnn
    from scp_tpu_torch.ops import window_attn
    from scp_tpu_torch.models.ehem import EHEM
    from scp_tpu_torch.weights import load_into

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    model = load_into(EHEM(static_knn=True, pallas_knn=args.pallas, pallas_attn=args.pallas,
                           dtype=torch.bfloat16, device="cuda"), CKPT)
    pts = synth_kitti(np.random.default_rng(0), N_POINTS)
    slices = split_levels(
        preprocess_points(pts, system="spher", qs=kitti_qs(LIDAR_LEVEL)).context, angular=True
    )
    codec = ehem_codec.EHEMCodec(model, context_size=8192)

    cold = roundtrip(codec, slices)
    warm = [roundtrip(codec, slices) for _ in range(2)]

    _wrap(codec, "_phase1", "phase1")
    _wrap(codec, "_phase2", "phase2")
    _wrap(rans, "_encode_chunk", "rans_encode_chunk")
    _wrap(rans, "_decode_chunk", "rans_decode_chunk")
    _wrap(ehem_codec, "_expand_windowed", "expand")
    _wrap(dgcnn, "knn_indices", "knn")
    _wrap(model, "_trunk", "trunk")
    _wrap(window_attn, "window_attention", "window_attention")  # kernel E's launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_t = roundtrip(codec, slices)

    names = ("phase1", "phase2", "trunk", "knn", "rans_encode_chunk",
             "rans_decode_chunk", "expand", "window_attention")
    events = prof.key_averages()

    def dev(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))

    def on_device(e):
        return str(getattr(e, "device_type", "")).endswith("CUDA")

    # device kernels only (CPU ops also carry the device time of what they launch)
    kernels = sorted(((e.key, dev(e) / 1e3, e.count) for e in events
                      if on_device(e) and e.key not in names and dev(e) > 0),
                     key=lambda r: -r[1])
    ranges = {}
    for e in events:
        if e.key in names:
            r = ranges.setdefault(e.key, {"count": e.count})
            if on_device(e):  # the range's span on the device timeline
                r["device_span_ms"] = dev(e) / 1e3
            else:  # host time inside the range, children included
                r["host_ms"] = e.cpu_time_total / 1e3
    device_ms = sum(k[1] for k in kernels)
    wall_ms = (prof_t[0] + prof_t[1]) * 1e3
    # idle share against the unprofiled warm wall (the profiler slows the host)
    warm_ms = 1e3 * sum(e + d for e, d, _ in warm) / len(warm)
    ours = {k: sum(ms for n, ms, _ in kernels if k in n)
            for k in ("scp::gemm_sm90", "scp::mlp_sm90", "scp::gemm_bf16",
                      "scp::attn_core_bf16", "knn_topk", "knn_topk_boxes", "knn_topk_pruned",
                      "knn_topk_wide", "row_sqnorm")}
    launches = {k: sum(c for n, _, c in kernels if k in n)
                for k in ("scp::gemm_sm90", "scp::mlp_sm90", "scp::gemm_bf16")}
    # the Swin sublayers' bf16 GEMMs: B/C's Hopper projection GEMM, A's
    # fused Hopper MLP kernel, and the WMMA GEMM (shapes past K = 256)
    ours["bf16 GEMMs + fused A"] = sum(ours[k] for k in launches)
    # B, C and E launch the same attention core; E's share is the device
    # span of its range (zero with --pallas off)
    ours["attn_core of E"] = ranges.get("window_attention", {}).get("device_span_ms", 0.0)
    ours["attn_core of B and C"] = ours["scp::attn_core_bf16"] - ours["attn_core of E"]
    out = {
        "card": card,
        "config": codec.coding_params(),
        "points": N_POINTS,
        "nodes": int(slices.occ_stream.shape[0]),
        "bpp": cold[2] / N_POINTS,
        "cold_s": {"encode": cold[0], "decode": cold[1]},
        "warm_s": [{"encode": e, "decode": d} for e, d, _ in warm],
        "profiled_s": {"encode": prof_t[0], "decode": prof_t[1]},
        "device_kernel_ms": device_ms,
        "device_idle_share": max(0.0, 1.0 - device_ms / warm_ms),
        "port_kernels_ms": ours,
        "gemm_launches": launches,
        "ranges": ranges,
        "top_kernels": [{"name": n[:120], "ms": ms, "count": c} for n, ms, c in kernels[:25]],
    }
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(out, fh, indent=1)
    print(card)
    print(out["config"])
    print(f"bpp {out['bpp']:.4f}; cold enc {cold[0]:.3f} s dec {cold[1]:.3f} s; warm "
          + ", ".join(f"enc {e:.3f} s dec {d:.3f} s" for e, d, _ in warm))
    print(f"profiled pass: wall {wall_ms:.1f} ms, kernels {device_ms:.1f} ms; warm wall "
          f"{warm_ms:.1f} ms, device idle share {out['device_idle_share']:.3f}; port kernels " + ", ".join(
              f"{k} {v:.1f} ms" for k, v in ours.items()))
    print("GEMM launches: " + ", ".join(f"{k} x{v}" for k, v in launches.items()))
    for k, v in sorted(ranges.items(), key=lambda kv: -kv[1].get("host_ms", 0)):
        print(f"  range {k} x{v['count']}: host {v.get('host_ms', 0):.1f} ms, "
              f"device span {v.get('device_span_ms', 0):.1f} ms")
    for r in out["top_kernels"][:15]:
        print(f"  kernel {r['ms']:9.2f} ms x{r['count']:6d}  {r['name'][:90]}")


if __name__ == "__main__":
    main()
