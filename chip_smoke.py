"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printed as it ends (any failure exits non-zero):
  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build of the hand-written kernels (one nvcc per source, in parallel);
  2. kernels A (MLP sublayer), B (self attention sublayer) and C (cross
     attention sublayer) against their plain PyTorch versions on the card,
     at the main path's widths (C=256, W=512, 4 heads, F=1024) and at the
     token counts of the L16 cloud's largest level, with the EHEM
     checkpoint's own block weights; kernel D (fused KNN distance +
     top-k) on that level's quantized positions (15, 8192, 3) (its pruned
     arm; index lists identical to the plain version's), on the same rows
     shuffled within each lane (nothing to prune; identical lists too),
     and on its wide arm: random (15, 8192, 144 / 192) features, the dynamic
     model's own EdgeConv 2 and 3 inputs of that call (15, 8192, 144) and
     (15, 8192, 192) (ehem_synth_f16.npz), k = 64 on random (2, 4096, 192)
     and C = 300 on random (2, 4096, 300); kernel E (window attention) at its
     on-path shape (1, 4, 512, 64) and at (240, 4, 512, 64); times of
     kernel, plain version and, where one PyTorch call computes the same
     function, that call;
  3. the full-width EHEM from checkpoints/ehem_synth_f16_sknn.npz (static
     KNN on), loaded through scp_tpu_torch.weights;
  4. one encode and one decode of the 120,000-point synthetic KITTI-like
     cloud at lidar level 16 (seed 0), with the lossless check; the kernel
     launch counts of that run show the path went through the kernels;
  5. the same roundtrip with the fused-kernel switches on (pallas_knn and
     pallas_attn, scp_tpu's SCP_PALLAS_KNN / SCP_PALLAS_ATTN): kernel D
     builds the position graphs of N >= 2048 rows, kernel E the attention
     of the padded deep Swin stages; lossless, and its bpp within 0.1% of
     phase 4's;
  6. the roundtrip of an f32 EHEM with pallas_attn on: kernels A, B, C and
     E in f32 (CUDA cores, no TF32); lossless, its bpp within 0.1% of the
     f32 figure of scp_tpu_torch/tools/rate_probe.py (plain f32 sublayers).

  7. training at full width (configs/train_kitti_ehem.yaml with the
     recipe of scp_tpu_torch/tools/train_bench_ckpt.py: batch 8 x context
     8192, bf16, remat off, vari_data_len on, Adam + StepLR, warm from
     ehem_synth_f16_sknn.npz, static KNN on), on shards that the port's
     gen_shards writes under chiprun_out/ (2 training clouds of 120,000
     points, seeds 1000-1001; 1 validation cloud, seed 5000) and removes
     when the phase ends:
     7a. one fixed (8, 8192) batch: the loss and every parameter's
         gradient through the kernels against the same model with its
         seams on their plain versions (`plain_seams`): loss within 1e-2
         relative, every parameter a gradient, per-tensor cosine >= 0.99;
         A, B and C on their Hopper arm on every launch of the step;
     7b. the same check with pallas_knn and pallas_attn on, on the batch
         cut to 2048 nodes (E runs on the padded deep stages, D builds
         the position graph): D and E launched;
     7c. 20 train_steps with vari_data_len: every loss finite; median
         s/step, peak memory, the forward / backward / update shares;
         then one profiled step at 8192 (and 7b's at 2048 for D and E):
         each kernel's forward ms and its plain backward's ms per step;
     7d. 10 steps on one repeated batch: the last loss below the first;
     7e. the trained parameters through save_params_npz and the codec's
         loader, then the L16 roundtrip: lossless (bpp printed, not gated).
  8. the codec CLI on the card: the bench sweep written as a KITTI .bin in
     a temp dir, a port run dir (configs/train_kitti_ehem.yaml through
     save_config, the sknn npz under <run>/ckpt/), then
     scp_tpu_torch.cli.encode.main (--type kitti --lidar_level 16 --spher
     --static-knn) and cli.decode.main with its ground-truth check, in this
     process.  Gates: the decoded points equal the encoder's quantized
     reconstruction (sorted, atol 1e-4); the .bin's payload equals, byte
     for byte, EHEMCodec.encode_to_stream of the same file's slices; its
     bpp is within 0.1% of phase 4's; A, B and C launch; the native octree
     builder built and ran, and its OctreeArrays on the cloud equal the
     numpy builder's.  Prints both preprocess times and the CLI's encode
     and decode walls by stage.
  9. OctAttention serving on the card: the full-width f32 OctAttention
     from checkpoints/octattn_synth_l12_v2.npz (through
     scp_tpu_torch.weights), the bench sweep at lidar level 12, spherical
     (365,165 nodes in 11 levels; the largest, 119,219 nodes, is 117
     chunks of 1024 -> 128 lanes).  scp_tpu computes the model with
     einsums, no Pallas kernel; the port's KV-cache step launches only the
     cached-attention kernel (phase 16) inside CUDA graphs, so kernels A-E
     launch 0 times here, and the phase says so.
     9a. the first 1024-row chunk of the largest level: the card's
         full-window logits against the CPU's (the same f32 model), and
         the card's KV-cache steps (decode_step / decode_insert at every
         position) against its full-window logits; atol = rtol = 1e-4;
     9b. the fused device-rANS schedule, encode and decode in this
         process: lossless; the payload's bits beside the ideal bits of
         the same CDF rows, sum(-log2(freq / 65536)), which they may
         exceed only by the coder's constants (32 bits of state per lane
         and the 2-byte header); bpp, the walls, the step loop's host
         time against the device's span, and its kernel launches per
         position (a profiled level); kernel K (phase 16) on the main
         path: every position of both directions a graph replay, K's
         launches in the roundtrip those of the replays and of each
         capture's one eager run (the kernel table's `launches`), and K's
         kernels in the profiled level's trace;
     9c. the CLIs in a temp dir: the sweep as a KITTI .bin, a run dir of
         configs/train_kitti.yaml with the v2 npz under ckpt/;
         cli.encode --incremental (the rans schedule) and cli.decode with
         its ground-truth check: lossless, and the payload byte for byte
         9b's stream; then the default window schedule on the native host
         coder (ac.cpp, built with g++), lossless.  Its decoder runs one
         1024-row forward per node (365,165 at L12), so it codes the same
         sweep at lidar level WINDOW_LEVEL.  Walls by stage.
 10. OctAttention training on the card (configs/train_kitti.yaml at full
     width: 600-d tokens, 3 layers, 4 heads, batch 16 x context 1024,
     bf16 with f32 masters, Adam + StepLR, warm from the v2 checkpoint),
     on shards that the port's data CLIs write under chiprun_out/ and
     that the phase removes when it ends.  Plain PyTorch, as in phase 9:
     kernels A-E launch 0 times here, and the phase checks it.  10b runs
     first, since 10a and 10c read its shards:
     10b. three synthetic KITTI sweeps (120,000 points, seeds 1000-1002)
          as .bin files in the sequences/<seq>/velodyne/ layout;
          `tools.multi_preproc 2` on `tools.preprocess --type kitti
          --spher`: three shards with the expected names (the first equal
          to preprocess_points's context), and a second run skips all
          three and rewrites none;
     10a. one fixed (16, 1024) batch of those shards at dropout 0: the
          card's f32 loss and every gradient leaf against the CPU's f32
          on the same model (the batch cut to 4 x 1024 on both sides,
          to keep the CPU's share short; loss within 1e-5 relative, each
          leaf within 1e-4 x max(1, its largest magnitude)), then the
          card's bf16 step against its f32 step on the whole batch (loss
          within 1e-2 relative, every parameter a gradient, per-tensor
          cosine >= 0.99; the key projections' biases, whose gradient is
          0 in exact arithmetic, at rounding level instead);
     10c. `cli.train.main --config-name train_kitti.yaml` on the shards,
          one epoch, dropout 0.1, validation batches at their default:
          every logged loss finite, metrics.jsonl and the final .pt
          written; then 20 timed steps at (16, 1024) at dropout 0.1 and
          at 0 (median s/step, peak memory, forward / backward / update
          shares), one profiled step (kernel ms by name, idle share), and
          10 steps on one repeated batch: the last loss below the first;
     10d. the trained run dir through `cli.encode --incremental` and
          `cli.decode` with its ground-truth check, on the bench sweep at
          lidar level 12 (phase 9's): lossless; bpp printed, not gated.
 11. EHEM's staged and full coding modes (scp_tpu's SCP_CODEC_MODE; the
     host arithmetic coder, native/src/ac.cpp) with phase 3's model:
     11a. phase 4's slices encoded and decoded in process in each mode:
          lossless; staged within 2% of full's bits; full within 1% of the
          ideal bits of a rans encode's symbols (its payload less the
          rANS lanes' final states), staged within 3%; each mode's encode
          and decode timers (`codec.timers`) and the decode wall split
          into model + fetch and host coder; A, B and C launch inside
          every phase call (decode_phase1: A and B, decode_phase2: A and
          C), D and E never;
     11b. the evaluation pipeline in a temp dir under chiprun_out/ that
          the phase removes: the sweep as a KITTI .bin,
          `tools.test_gene --type kitti --lidar_level 16 --spher` (shard,
          _quant.ply, _meta.npy, _manifest.npz), then `cli.encode
          --static-knn --ehem-mode staged|full --preproc_path` and
          `cli.decode` with its ground-truth check: lossless, the header
          names the mode, the payload byte for byte the codec's in-process
          stream of the shard's slices; `tools.psnr_test --with_normals`
          on the _quant.ply (normals from the native k-NN); the native
          KD-tree's D1, D2 and Chamfer against scipy's on the sweep and its
          quantized cloud within 1e-9 relative (both times printed); and
          phase 8's metrics stage ran on the native library (its time).
 12. data-parallel training and multi-device coding (train/distributed.py,
     EHEMCodec(devices=...), tools/bench.py's pipeline,
     tools/dryrun_multichip.py), with n = torch.cuda.device_count():
     12a. the ranks: n over NCCL, one per card, or 2 over gloo on cuda:0
          when n = 1 (and then a one-rank NCCL group on the card, one
          all-reduce); phase 7's recipe (train_kitti_ehem.yaml, global
          batch 8 x 8192, warm from the sknn npz) on two sweeps' shards:
          the world's step against the one-rank step on the same global
          batch, in f32 (loss within 1e-5 relative, every gradient leaf
          within 1e-4 x max(1, its largest magnitude), statistics 1e-5)
          and in bf16 (loss 1e-2, per-tensor gradient cosine >= 0.99,
          statistics 1e-2); on every rank the same global loss, the same
          updated parameters, the same BatchNorm statistics, and A, B and
          C launched; OctAttention (train_kitti.yaml, 16 x 1024, dropout
          0.1) the same way in f32; s/step at one rank and on each rank
          (5 timed bf16 steps), the all-reduce's share, peak memory;
     12b. the sharded codec over every card (cuda:0 twice when n = 1)
          with phase 3's model on phase 4's slices: lossless, bpp within
          0.1% of phase 4's, every phase call of every shard's replica
          launched its kernels (A and B in phase 1, A and C in phase 2),
          the stamp names the device count and a one-device decoder
          refuses the stream; cold and warm walls beside phase 4's, and a
          profiled warm roundtrip of each (wall, kernel ms per card);
     12c. three sweeps (seeds 0-2) in flight through one codec
          (tools/bench.py's pipeline_bench): lossless, each payload byte
          for byte its serial encode; the wall beside three serial
          roundtrips;
     12d. tools/dryrun_multichip at max(n, 2): scp_tpu's two lines.
     Any rank that fails, hangs past 600 s, or fails its process group's
     setup fails the phase.  `--phase12-only` runs phases 0, 1, 3, 4 and
     12 alone (a multi-card run of this phase; no kernel table).
 13. the last tools (tools/import_torch_ckpt.py, tools/profile_codec.py,
     tools/precompile.py), in a scratch directory under chiprun_out/ that
     the phase removes:
     13a. the sknn checkpoint as a reference SCP state_dict
          (`reference_state_dict`, the inverse of the importer's rules:
          q|k|v split, torch layouts, the skipped buffers added) in a
          Lightning-style .ckpt, imported by `tools.import_torch_ckpt
          --model ehem` in a fresh process (weights_only load, the
          structure checked on the card): every array equal to the npz's
          bit for bit; the imported full-width model codes phase 4's
          slices losslessly with a payload byte-identical to phase 4's, A
          and B launched in every phase-1 call and A and C in every
          phase-2 call; the same for OctAttention from the v2 checkpoint,
          whose imported model's logits on a 1024-row window of the L12
          sweep equal the npz-loaded model's bit for bit;
     13b. `tools.profile_codec --what codec --group 8` in rans, staged and
          full modes and `--what train --batch 8` with remat off and on
          (tools/profile_train.py's timed steps of phase 7's recipe) in
          this process, their JSON lines printed: every time finite and
          positive, every MFU in (0, 100] against the bf16 peak, A, B and
          C launched in the timed calls;
     13c. `tools.precompile --points 120000 --levels 16` in a fresh
          process: all five kernel libraries and the native one reused,
          its phase-shape count equal to phase 4's plan; seed and re-warm
          times printed.
 14. the dynamic-graph EHEM (JAX's default DGCNN: static KNN off, EdgeConv
     2 and 3 rebuild their graphs on their C = 144 and 192 features) at
     full width from checkpoints/ehem_synth_f16.npz, bf16, context 8192, on
     phase 4's cloud; three roundtrips, each lossless:
     14a. the switches off (the chunked KNN on all three graphs): bpp
          printed beside the root bench.py's TPU record, 18.175;
     14b. pallas_knn: kernel D builds all three graphs of every phase-1
          call of N >= 2048 rows, one launch on its pruned arm (positions)
          and two on its wide arm (features) per call, counted by arm; its
          stamp names the wide arm (knnwide=exactdot), 14a's does not;
     14c. 14b's model with the DGCNN's own plain_seams (D's plain version
          on the card; A, B and C stay kernels): 14b's bpp within 0.1% of
          14c's (both score the graphs in f32; 14a's gap to them is
          printed, not gated).
     Walls and the KNN seam's CUDA-event time by graph width per roundtrip.
 15. the rANS coder's kernels (ops/csrc/rans.cu) against the plain step
     loops of codec/rans.py, both on the card, at the main path's shapes:
     one 65,536-symbol chunk and the L16 level's even-parity group (rows
     from logits_to_cdf of random logits, symbols drawn from them): the
     same stream bytes, symbols and (states, ptr); CUDA-event times of a
     decode group and an encode, kernel and plain loops; the kernels'
     launches in phase 4's roundtrip; their registers and spills (phase 1).
 16. the cached attention of OctAttention's KV-cache step
     (ops/csrc/cached_attn.cu) against its plain version at the octattn
     cell's deepest step (128 lanes, 4 heads, cache length 1023, hd 150)
     and at 32, 8 and 1 lanes, f32 and bf16: CUDA-event times of the
     kernel (the length a device scalar), of the plain version and of the
     step's eager batched products (library), beside the bytes bound; its
     registers and spills (phase 1).  The kernel's time is that of launches
     replayed from a CUDA graph, as the step runs it (the eager launch's
     host cost beside it).

Phase 2 also holds A, B, C and E in f32 against their plain versions
(atol = rtol = 1e-4), and times the attention core that B, C and E share
at B's layout and token count beside scaled_dot_product_attention.  For
A, B and C it checks that two launches give identical bits, and times
their bf16 products alone: through the port's Hopper GEMM (B, C; A's
fused kernel is its products) and through cuBLAS without LN or epilogue
(`products_library_ms`, F.linear: a yardstick for the products only, so
`library_ms` stays null).  For D's pruned arm it prints the share of the
brute-force (warp, group) pairs scored on both row orders, read from the
kernel's counter; D's bound counts the pairs this input needed.  Phase 1
reads the registers and spills of each Hopper GEMM kernel and of D's
kernels (both arms) from the ptxas -v build log and fails on a spill; phase 4
checks that A, B and C took the Hopper kernels on every launch.

The second-to-last line is the JSON kernel table; the last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX or scp_tpu.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(HERE, "checkpoints", "ehem_synth_f16_sknn.npz")
# JAX's default DGCNN, the dynamic graph (phase 14; phase 2's model features)
DYN_CKPT = os.path.join(HERE, "checkpoints", "ehem_synth_f16.npz")
OCT_CKPT = os.path.join(HERE, "checkpoints", "octattn_synth_l12_v2.npz")
OCT_LEVEL = 12  # phase 9: the octattn checkpoint's training level
# phase 9c's window schedule: one 1024-row forward per node at decode, so
# it codes the sweep at a coarser level (7,357 nodes)
WINDOW_LEVEL = 8
N_POINTS = 120_000
LIDAR_LEVEL = 16
TOL = 3e-2  # atol = rtol: bf16 outputs (8-bit mantissa), kernel vs plain summation order
F32_TOL = 1e-4  # atol = rtol: f32 outputs, summation order over K <= 1024 (TF32 would miss it)
# phase 16: the bf16 cached attention against the f32 products of its operands
ATTN_BF16_RTOL = 2.0**-7  # twice the output's rounding (half a bf16 ulp <= 2^-8 relative)
ATTN_BF16_ATOL = 1e-5  # f32 summation order over <= 1024 rows of O(1) terms
# kernel D vs its plain version at C > 4: the index lists may differ only
# where the two sum a dot product in other orders and a near tie swaps; the
# exact (f64) distances of both picks agree within KNN_RTOL on every row.
# On positions (C = 3, the pruned arm) the lists must be identical.
KNN_SAME_ROWS = 0.999
KNN_RTOL = 1e-5
BPP_RTOL = 1e-3  # phase 5 vs phase 4: f32 instead of bf16 KNN scores
# phase 4 vs the main path's rate before the attention core was unified
# (chip_smoke.py phase 4 on the H100, PERF.md section 6)
MAIN_PATH_BPP = 18.4428
# phase 6 vs the f32 model with plain sublayers (tools/rate_probe.py, the
# L16 cloud on the H100, PERF.md section 6)
F32_PLAIN_BPP = 18.4245
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # CUDA cores, no tensor cores
PEAK_BYTES = 3.35e12


def say(*args):
    print(*args, flush=True)


def synth_kitti(rng, n):
    """Ring-structured LiDAR-like sweep (the bench.py cloud generator)."""
    beams = 64
    el = np.deg2rad(np.linspace(-24.8, 2.0, beams))[rng.integers(0, beams, n)]
    az = rng.uniform(0, 2 * np.pi, n)
    r = np.clip(rng.gamma(3.0, 8.0, n) + 2.0, 2.0, 120.0)
    x = r * np.cos(el) * np.cos(az)
    y = r * np.cos(el) * np.sin(az)
    z = r * np.sin(el)
    return np.stack([x, y, z], 1)


def cuda_time_ms(fn, reps: int, warm: int = 1) -> float:
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def check_close(name, got, want, tol=TOL, rtol=None):
    """|got - want| <= tol + rtol |want| everywhere (rtol defaults to tol)."""
    rtol = tol if rtol is None else rtol
    err = (got.float() - want.float()).abs()
    bound = tol + rtol * want.float().abs()
    max_err = float(err.max())
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    bad = int((err > bound).sum())
    say(f"  {name}: max_abs_err={max_err:.6g} (tolerance atol={tol}, rtol={rtol}), "
        f"elements over tolerance: {bad}")
    if bad:
        raise AssertionError(f"{name}: {bad} elements over tolerance")
    return max_err


def check_repeat(name, fn):
    """Two launches on the same inputs must give identical bits: the encoder
    and the decoder must see the same logits.  Returns the first output."""
    got = fn()
    again = fn()
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches on the same inputs differ")
    say(f"  {name}: two launches bit-identical")
    return got


def gemm_part(name, calls, flops, library_calls):
    """The sublayer's bf16 products through the port's GEMM kernels alone
    (`calls`: the Hopper GEMM at the sublayer's shapes, with its LN,
    bias and residual) and through cuBLAS without LN or epilogue
    (`library_calls`, F.linear: a yardstick for the products, not the
    same function); times and the GEMM's achieved TFLOP/s."""
    ms = cuda_time_ms(lambda: [c() for c in calls], 10)
    lib = cuda_time_ms(lambda: [c() for c in library_calls], 10)
    say(f"  {name} GEMM part: {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), cuBLAS products "
        f"{lib:.4f} ms ({flops / lib / 1e9:.1f} TFLOP/s)")
    return dict(gemm_ms=ms, gemm_tflops=flops / ms / 1e9, products_library_ms=lib)


def check_knn(name, got, again, want, feats, min_rows=KNN_SAME_ROWS):
    """Kernel D's picks against the plain version's: identical index lists
    on >= min_rows of the rows; returns the largest difference of their
    sorted f64 distances."""
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches on the same input differ")
    same = float((got == want).all(-1).double().mean())
    f = feats.double()
    max_err, bad = 0.0, 0
    for b in range(f.shape[0]):
        def dists(idx):
            return ((f[b][idx[b]] - f[b][:, None]) ** 2).sum(-1).sort(-1).values

        dg, dw = dists(got), dists(want)
        err = (dg - dw).abs()
        max_err = max(max_err, float(err.max()))
        bad += int((err > KNN_RTOL * dw).sum())
    say(f"  {name}: identical index lists on {same:.6f} of rows (need >= {min_rows}), "
        f"distances over rtol {KNN_RTOL}: {bad}, max abs distance difference {max_err:.6g}")
    if same < min_rows or bad:
        raise AssertionError(f"{name}: kernel picks disagree with the plain version")
    return max_err


def level_positions(slices, lanes: int, width: int):
    """The positions the largest level's (lanes, width) call gives the
    position graph: pad rows at 0, normalized and quantized to 16 bits as
    EHEMCodec._phase1 does, in bf16 as the model casts them."""
    from scp_tpu_torch.codec.ehem_codec import EHEMCodec

    li = int(np.argmax(slices.level_sizes))
    pos = np.zeros((lanes * width, 3), np.int64)
    n = min(len(slices.pos_int[li]), lanes * width)
    pos[:n] = slices.pos_int[li][:n]
    lo, scale = EHEMCodec._norm_params(slices.pos_mm[li], slices.max_level, True)
    f32 = torch.float32
    pf = (torch.from_numpy(pos) - lo).to(f32) * torch.tensor(scale, dtype=f32)
    pu = torch.round(torch.clamp(pf, 0.0, 1.0) * torch.tensor(65535.0, dtype=f32))
    pq = pu.to(torch.int32).to(f32) * torch.tensor(np.float32(1.0 / 65535.0))
    return pq.reshape(lanes, width, 3).to("cuda", torch.bfloat16)


def bound_ms(n_bytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def f32_row(name, kernel, plain, args, n_bytes, flops, reps=3):
    """A kernel in f32 against its plain version (F32_TOL): error, times
    and the f32 bound (bytes doubled from bf16, CUDA-core peak)."""
    got = kernel(*args)
    torch.cuda.synchronize()
    err = check_close(f"{name} in f32", got, plain(*args), F32_TOL)
    b, by = bound_ms(n_bytes, flops, PEAK_F32_FLOPS)
    return dict(f32_max_abs_err=err, f32_ms=cuda_time_ms(lambda: kernel(*args), reps),
                f32_plain_ms=cuda_time_ms(lambda: plain(*args), 2), f32_bound_ms=b,
                f32_bound_by=by)


def f32_args(args):
    """bf16 tensors of an argument tuple as f32 (weights, activations)."""
    return tuple(a.float() if torch.is_tensor(a) and a.dtype == torch.bfloat16 else a
                 for a in args)


def n_masks(mask):
    return 0 if mask is None else mask.shape[0]


def sdpa_bias(bias, mask, n_win):
    """SDPA's attn_mask for the same logits: bias (+ window n's mask), bf16."""
    if mask is None:
        return bias[None].to(torch.bfloat16)
    mask_b = mask[torch.arange(n_win, device=mask.device) % mask.shape[0]]
    return (bias[None] + mask_b[:, None]).to(torch.bfloat16)


def core_at_b_layout(rand, n_win, w, c, h, bias, mask):
    """The attention core B, C and E share, at B's layout (q, k, v the
    column-strided (BN*W, 3C) projection buffer) and token count, against
    its plain version and beside SDPA on the same inputs (contiguous
    copies, the bf16 bias + mask as attn_mask)."""
    from scp_tpu_torch.ops import window_attn

    hd = c // h
    qkv = rand(n_win * w, 3 * c)
    q, k, v = (qkv[:, i * c:(i + 1) * c].reshape(n_win, w, h, hd).permute(0, 2, 1, 3)
               for i in range(3))
    att = torch.empty((n_win * w, c), dtype=qkv.dtype, device=qkv.device)
    out = att.reshape(n_win, w, h, hd).permute(0, 2, 1, 3)
    args = (q, k, v, bias, mask, hd ** -0.5)
    window_attn.launch_core(*args, out)
    torch.cuda.synchronize()
    err = check_close(f"B core at B's layout ({n_win}, {h}, {w}, {hd}), {mask.shape[0]} masks",
                      out, window_attn.window_attention_plain(*args))
    sdpa_mask = sdpa_bias(bias, mask, n_win)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    nb = 4 * n_win * w * c * 2 + h * w * w * 4 + mask.numel() * 4
    b, by = bound_ms(nb, 4 * n_win * h * w * w * hd)
    row = dict(
        core_max_abs_err=err, core_ms=cuda_time_ms(lambda: window_attn.launch_core(*args, out), 10),
        core_plain_ms=cuda_time_ms(lambda: window_attn.window_attention_plain(*args), 3),
        core_library_ms=cuda_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qc, kc, vc, attn_mask=sdpa_mask, scale=hd ** -0.5), 10),
        core_bound_ms=b, core_bound_by=by,
    )
    del sdpa_mask
    return row


def kernel_phase(model, gen, slices, dyn_feats):
    """Phase 2: each kernel against its plain version; returns table rows.
    `dyn_feats`: the dynamic model's EdgeConv 2 and 3 inputs of the
    largest level's call (dynamic_features)."""
    from scp_tpu_torch.models.swin1d import _mask_tensor
    from scp_tpu_torch.ops import knn, knn_topk, proj_gemm, window_attn
    from scp_tpu_torch.ops import mlp as mlp_ops
    from scp_tpu_torch.ops import swin_attn

    F = torch.nn.functional
    dev = torch.device("cuda")
    c, w, h, f = 256, 512, 4, 1024
    lanes, width = 15, 8192  # the L16 cloud's largest level: one (15, 8192) call
    m_self = lanes * width  # phase-1 stage-0 tokens
    m_cross = lanes * width // 2  # phase-2 stage-0 tokens
    rows = {}

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    # ---- A: MLP sublayer, phase-1 stage 0 block 0 weights
    blk = model.swin_self.stage_0.block_0
    x = rand(m_self, c)
    w1, w2 = blk.mlp1.kernel(), blk.mlp2.kernel()  # the compute-dtype casts of the f32 masters
    args = (x, blk.norm2.weight, blk.norm2.bias, w1, blk.mlp1.bias, w2, blk.mlp2.bias, 1e-5,
            "gelu")
    got = check_repeat("A ln_mlp_residual (gelu)", lambda: mlp_ops.ln_mlp_residual(*args))
    err = check_close("A ln_mlp_residual (gelu)", got, mlp_ops.ln_mlp_residual_plain(*args))
    ms = cuda_time_ms(lambda: mlp_ops.ln_mlp_residual(*args), 10)
    plain = cuda_time_ms(lambda: mlp_ops.ln_mlp_residual_plain(*args), 3)
    nb = 2 * m_self * c * 2 + 2 * c * f * 2 + 4 * (3 * c + f)
    flops = 2 * 2 * m_self * c * f
    b, by = bound_ms(nb, flops)
    lib = cuda_time_ms(lambda: F.linear(F.linear(x, w1), w2), 10)
    say(f"  A: {flops / ms / 1e9:.1f} TFLOP/s fused; cuBLAS products {lib:.4f} ms "
        f"({flops / lib / 1e9:.1f} TFLOP/s)")
    rows["A"] = dict(
        name="ln_mlp_residual", route="cuda", source="scp_tpu_torch/ops/csrc/mlp.cu",
        replaces="scp_tpu/ops/pallas_mlp.py:96", max_abs_err=err, ms=ms,
        plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None,
        tokens=m_self, gemm_ms=ms, gemm_tflops=flops / ms / 1e9, products_library_ms=lib,
        **f32_row("A ln_mlp_residual (gelu)", mlp_ops.ln_mlp_residual,
                                 mlp_ops.ln_mlp_residual_plain, f32_args(args), 2 * nb,
                                 2 * 2 * m_self * c * f),
    )

    # ---- B: self attention sublayer, unshifted (block 0) and shifted (block 1)
    errs, ms_list, plain_list = [], [], []
    for bi, shift in ((0, 0), (1, w // 2)):
        blk = getattr(model.swin_self.stage_0, f"block_{bi}")
        at = blk.attn
        mask = _mask_tensor(width, w, shift, dev) if shift else None  # as the seam passes it
        xw = rand(m_self // w, w, c)
        wqkv, wp = at.qkv.kernel(), at.proj.kernel()
        args = (xw, blk.norm1.weight, blk.norm1.bias, wqkv, at.qkv.bias,
                at.rel_bias(), mask, wp, at.proj.bias, h, 1e-5)
        tag = f"B attn_sublayer_self (shift {shift}, {n_masks(mask)} masks)"
        got = check_repeat(tag, lambda: swin_attn.attn_sublayer_self(*args))
        errs.append(check_close(tag, got, swin_attn.attn_sublayer_self_plain(*args)))
        ms_list.append(cuda_time_ms(lambda: swin_attn.attn_sublayer_self(*args), 10))
        plain_list.append(cuda_time_ms(lambda: swin_attn.attn_sublayer_self_plain(*args), 2))
    n_win = m_self // w
    flops = 2 * m_self * c * 3 * c + 4 * n_win * w * w * c + 2 * m_self * c * c
    nb = 2 * m_self * c * 2 + 4 * c * c * 2 + h * w * w * 4 + mask.numel() * 4
    b, by = bound_ms(nb, flops)
    x2, a2 = xw.reshape(m_self, c), rand(m_self, c)
    ln = (blk.norm1.weight, blk.norm1.bias)
    gemm_b = gemm_part(
        "B", (lambda: proj_gemm.linear(x2, wqkv, at.qkv.bias, ln=ln),
              lambda: proj_gemm.linear(a2, wp, at.proj.bias, resid=x2)),
        2 * m_self * c * 4 * c,
        (lambda: F.linear(x2, wqkv), lambda: F.linear(a2, wp)))
    rows["B"] = dict(
        name="attn_sublayer_self", route="cuda", source="scp_tpu_torch/ops/csrc/swin_attn.cu",
        replaces="scp_tpu/ops/pallas_swin.py:63", max_abs_err=max(errs), ms=ms_list[1],
        plain_ms=plain_list[1], bound_ms=b, bound_by=by, library_ms=None,
        tokens=m_self, ms_unshifted=ms_list[0], **gemm_b,
        **f32_row(f"B attn_sublayer_self (shift {w // 2})", swin_attn.attn_sublayer_self,
                  swin_attn.attn_sublayer_self_plain, f32_args(args), 2 * nb, flops),
        **core_at_b_layout(rand, n_win, w, c, h, blk.attn.rel_bias(), mask),
    )

    # ---- C: cross attention sublayer, phase-2 stage 0 block 1 (shifted)
    blk = model.swin_cross.stage_0.block_1
    at = blk.attn
    mask = _mask_tensor(width // 2, w, w // 2, dev)
    xw, qs = rand(m_cross // w, w, c), rand(m_cross // w, w, c)
    wq, wkv, wp = at.query.kernel(), at.kv.kernel(), at.proj.kernel()
    args = (xw, qs, blk.norm1.weight, blk.norm1.bias, wq, at.query.bias,
            wkv, at.kv.bias, at.rel_bias(), mask, wp, at.proj.bias,
            h, 1e-5)
    tag = f"C attn_sublayer_cross (shift {w // 2}, {mask.shape[0]} masks)"
    got = check_repeat(tag, lambda: swin_attn.attn_sublayer_cross(*args))
    err = check_close(tag, got, swin_attn.attn_sublayer_cross_plain(*args))
    ms = cuda_time_ms(lambda: swin_attn.attn_sublayer_cross(*args), 10)
    plain = cuda_time_ms(lambda: swin_attn.attn_sublayer_cross_plain(*args), 2)
    n_win = m_cross // w
    flops = 2 * m_cross * c * 4 * c + 4 * n_win * w * w * c
    nb = 3 * m_cross * c * 2 + 4 * c * c * 2 + h * w * w * 4 + mask.numel() * 4
    b, by = bound_ms(nb, flops)
    x2, q2, a2 = xw.reshape(m_cross, c), qs.reshape(m_cross, c), rand(m_cross, c)
    ln = (blk.norm1.weight, blk.norm1.bias)
    gemm_c = gemm_part(
        "C", (lambda: proj_gemm.linear(q2, wq, at.query.bias, ln=ln),
              lambda: proj_gemm.linear(x2, wkv, at.kv.bias, ln=ln),
              lambda: proj_gemm.linear(a2, wp, at.proj.bias, resid=x2)),
        2 * m_cross * c * 4 * c,
        (lambda: F.linear(q2, wq), lambda: F.linear(x2, wkv), lambda: F.linear(a2, wp)))
    rows["C"] = dict(
        name="attn_sublayer_cross", route="cuda", source="scp_tpu_torch/ops/csrc/swin_attn.cu",
        replaces="scp_tpu/ops/pallas_swin.py:96", max_abs_err=err, ms=ms,
        plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None, tokens=m_cross, **gemm_c,
        **f32_row(f"C attn_sublayer_cross (shift {w // 2})", swin_attn.attn_sublayer_cross,
                  swin_attn.attn_sublayer_cross_plain, f32_args(args), 2 * nb, flops),
    )

    # ---- D: fused KNN distance + top-k, k = 20: the L16 position graph of
    # the (15, 8192) call (the pruned arm), the same rows shuffled within
    # each lane (nothing to prune), then the wide arm: the dynamic graph's
    # widths on random features, the dynamic model's own EdgeConv 2
    # and 3 inputs of that call (C = 144, 192), and the Pallas kernel's
    # reach past the old caps (k = 64; C = 300) on random (2, 4096) rows
    k = 20
    d_shapes = {}
    pos = level_positions(slices, lanes, width)
    perm = torch.randperm(width, generator=gen, device=dev)
    for tag, feats, kk in (
        ("positions", pos, k),
        ("shuffled", pos[:, perm].contiguous(), k),
        ("c144", rand(lanes, width, 144), k),
        ("c192", rand(lanes, width, 192), k),
        ("dyn_f2", dyn_feats[0], k),
        ("dyn_f3", dyn_feats[1], k),
        ("k64", rand(2, 4096, 192), 64),
        ("c300", rand(2, 4096, 300), k),
    ):
        b_, n_, c_ = feats.shape
        pruned = knn_topk.takes_pruned_arm(c_, kk)
        stats = torch.zeros(1, dtype=torch.int64, device=dev) if pruned else None
        got = knn_topk.knn_topk(feats, kk, stats=stats)
        again = knn_topk.knn_topk(feats, kk)
        want = knn_topk.knn_topk_plain(feats, kk)
        torch.cuda.synchronize()
        err = check_knn(f"D knn_topk {tuple(feats.shape)} k={kk} {tag}", got, again, want,
                        feats, min_rows=1.0 if pruned else KNN_SAME_ROWS)
        # the work this input needs: the (warp, group) pairs the pruned arm
        # scored (8 queries x 32 keys each), every pair for the wide arm
        total = b_ * -(-n_ // knn_topk.QPW) * -(-n_ // knn_topk.GROUP)
        visited = int(stats) if pruned else total
        pairs = visited * knn_topk.QPW * knn_topk.GROUP if pruned else b_ * n_ * n_
        b, by = bound_ms(b_ * n_ * c_ * 2 + b_ * n_ * kk * 8, 2 * pairs * c_)
        d_shapes[tag] = dict(
            err=err, ms=cuda_time_ms(lambda: knn_topk.knn_topk(feats, kk), 10), bound=b, by=by,
            visited=visited, total=total, shape=[b_, n_, c_], k=kk,
        )
        if tag != "shuffled":  # the same function of the same rows as "positions"
            d_shapes[tag].update(
                plain=cuda_time_ms(lambda: knn_topk.knn_topk_plain(feats, kk), 3),
                main=cuda_time_ms(lambda: knn.knn_indices(feats, kk), 3))
        if pruned:
            say(f"  D {tag}: scored {visited} of {total} (warp, group) pairs, "
                f"share {visited / total:.4f} of the brute-force work")
        else:
            say(f"  D {tag} (wide arm) {tuple(feats.shape)} k={kk}: {d_shapes[tag]['ms']:.4f} ms, "
                f"plain {d_shapes[tag]['plain']:.4f}, main-path KNN {d_shapes[tag]['main']:.4f}, "
                f"bound {b:.4f} ms ({by}), {2 * pairs * c_ / d_shapes[tag]['ms'] / 1e9:.1f} "
                f"TFLOP/s")
    dp, ds = d_shapes["positions"], d_shapes["shuffled"]
    wide = {}
    for tag in ("c144", "c192", "dyn_f2", "dyn_f3", "k64", "c300"):
        w_ = d_shapes[tag]
        wide.update({f"{tag}_shape": w_["shape"], f"{tag}_k": w_["k"], f"{tag}_ms": w_["ms"],
                     f"{tag}_plain_ms": w_["plain"], f"{tag}_bound_ms": w_["bound"],
                     f"{tag}_bound_by": w_["by"], f"{tag}_main_path_knn_ms": w_["main"],
                     f"{tag}_max_abs_err": w_["err"]})
    rows["D"] = dict(
        name="knn_topk", route="cuda", source="scp_tpu_torch/ops/csrc/knn_topk.cu",
        replaces="scp_tpu/ops/pallas_knn.py:59",
        max_abs_err=max(w_["err"] for w_ in d_shapes.values()), ms=dp["ms"],
        plain_ms=dp["plain"], bound_ms=dp["bound"], bound_by=dp["by"], library_ms=None,
        library_note="no one PyTorch call computes distance + top-k (torch.cdist, then "
                     "torch.topk, is two)",
        shape=[lanes, width, 3], main_path_knn_ms=dp["main"],
        groups_visited=dp["visited"], groups_visited_shuffled=ds["visited"],
        groups_total=dp["total"], groups_visited_share=dp["visited"] / dp["total"],
        groups_visited_shuffled_share=ds["visited"] / ds["total"],
        shuffled_ms=ds["ms"], shuffled_bound_ms=ds["bound"], shuffled_bound_by=ds["by"],
        **wide,
    )

    # ---- E: window attention at its on-path shape (one padded window of
    # the 256-token stage, unshifted) and at B's token count, shifted
    blk = model.swin_self.stage_3.block_0
    bias = blk.attn.rel_bias()
    e_shapes = {}
    hd = c // h
    for tag, bn, mask in (
        ("on_path", 1, None),
        ("bn240", m_self // w, _mask_tensor(2 * w, w, w // 2, dev)),
    ):
        q, k_, v = (rand(bn, h, w, hd) for _ in range(3))
        args = (q, k_, v, bias, mask, hd ** -0.5)
        got = window_attn.window_attention(*args)
        torch.cuda.synchronize()
        err = check_close(f"E window_attention ({bn}, {h}, {w}, {hd}), {n_masks(mask)} masks",
                          got, window_attn.window_attention_plain(*args))
        sdpa_mask = sdpa_bias(bias, mask, bn)
        nb = 4 * bn * h * w * hd * 2 + h * w * w * 4 + n_masks(mask) * w * w * 4
        b, by = bound_ms(nb, 4 * bn * h * w * w * hd)
        e_shapes[tag] = dict(
            err=err, ms=cuda_time_ms(lambda: window_attn.window_attention(*args), 10),
            plain=cuda_time_ms(lambda: window_attn.window_attention_plain(*args), 3),
            lib=cuda_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k_, v, attn_mask=sdpa_mask, scale=hd ** -0.5), 10),
            bound=b, by=by, tokens=bn * w, args=args, nb=nb,
        )
        del sdpa_mask
    ep, eb = e_shapes["on_path"], e_shapes["bn240"]
    e32 = f32_row(f"E window_attention {tuple(eb['args'][0].shape)}",
                  window_attn.window_attention, window_attn.window_attention_plain,
                  f32_args(eb["args"]), 2 * eb["nb"], 4 * eb["tokens"] * h * w * hd)
    rows["E"] = dict(
        name="window_attention", route="cuda", source="scp_tpu_torch/ops/csrc/window_attn.cu",
        replaces="scp_tpu/ops/pallas_attn.py:41", max_abs_err=max(ep["err"], eb["err"]),
        ms=ep["ms"], plain_ms=ep["plain"], bound_ms=ep["bound"], bound_by=ep["by"],
        library_ms=ep["lib"], library_note="scaled_dot_product_attention with the bf16 "
        "bias + mask as attn_mask", shape=[1, h, w, hd], tokens=ep["tokens"],
        bn240_shape=[m_self // w, h, w, hd], bn240_ms=eb["ms"], bn240_plain_ms=eb["plain"],
        bn240_bound_ms=eb["bound"], bn240_bound_by=eb["by"], bn240_library_ms=eb["lib"],
        f32_shape=[m_self // w, h, w, hd], **e32,
    )
    return rows


def check_spills(rows, what):
    """Prints each kernel's registers, spills and stack frame; fails on a
    spill, or when the build logs hold no kernel of `what`."""
    for k, r in sorted(rows.items()):
        say(f"  {k}: {r['registers']} registers at entry, spill stores {r['spill_stores']} B, "
            f"spill loads {r['spill_loads']} B, stack frame {r.get('stack')} B")
        if r["spill_stores"] or r["spill_loads"]:
            raise AssertionError(f"{k} spills registers")
    if not rows:
        raise AssertionError(f"no {what} kernel in the build logs")
    return rows


def sm90_resources(cuda):
    """Registers and spills of the Hopper GEMM kernels (ptxas -v, from the
    build log); fails on any spill."""
    rows = {}
    for src in ("mlp.cu", "swin_attn.cu"):
        for r in cuda.ptxas_report(src, "sm90"):
            name = "mlp_sm90" if "mlp_sm90" in r["kernel"] else "gemm_sm90"
            targs = re.findall(r"L[ib](\d+)", r["kernel"].split("EEEv", 1)[0])
            rows[f"{name}<{','.join(targs)}>"] = r
    return check_spills(rows, "Hopper GEMM")


def knn_resources(cuda):
    """Registers and spills of kernel D: the pruned arm's search, by row
    width in floats (4: up to 3 coordinates, 8: 4), its pre-pass, by
    element type and C, and the wide arm, by element type and list slots
    per lane (1: k <= 32, 2: k <= 64); fails on any spill."""
    rows = {}
    for name in ("knn_topk_pruned", "knn_topk_boxes", "knn_topk_wide"):
        for r in cuda.ptxas_report("knn_topk.cu", name):
            targs = re.findall(r"Li(\d+)E", r["kernel"])
            if name != "knn_topk_pruned":
                targs.insert(0, "bf16" if "bfloat16" in r["kernel"] else "f32")
            rows[f"{name}<{','.join(targs)}>"] = r
    if not any(k.startswith("knn_topk_wide<") for k in rows):
        raise AssertionError("no knn_topk_wide kernel in the build log")
    return check_spills(rows, "KNN")


def roundtrip(codec, slices, counted):
    """One cold encode and one cold decode with the lossless check; the
    kernel counts are set to 0 just before and read just after."""
    from scp_tpu_torch.tools.profile_train import reset_counts

    reset_counts(counted)
    torch.cuda.synchronize()
    t0 = time.time()
    stream, bits, _ = codec.encode_to_stream(slices)
    torch.cuda.synchronize()
    t_enc = time.time() - t0
    t0 = time.time()
    dec = codec.new_stream_decoder(stream, codec.ac_symbols_per_node * len(slices.occ_stream),
                                   coding_params=codec.coding_params())
    codes = codec.decode(dec, slices.max_level, np.array(slices.pos_mm, np.int64),
                         angular=True, ground_truth=slices.occ_stream,
                         level_sizes=slices.level_sizes)
    torch.cuda.synchronize()
    t_dec = time.time() - t0
    launches = [fn.launches for fn in counted]
    if codes.shape != slices.occ_stream.shape or not (codes == slices.occ_stream).all():
        raise AssertionError("decode is not lossless")
    bpp = bits / N_POINTS
    if not math.isfinite(bpp) or bits <= 0:
        raise AssertionError(f"bad bit count {bits}")
    return dict(bpp=bpp, bytes=len(stream), sha256=hashlib.sha256(stream).hexdigest(),
                encode_s=t_enc, decode_s=t_dec, launches=launches)


# ---- phase 7: training ------------------------------------------------------

GRAD_COSINE = 0.99  # per-tensor cosine of the kernel step's gradients to the plain step's
LOSS_RTOL = 1e-2  # the bf16 loss through the kernels vs through the plain versions


def grad_check(name, model_k, model_p, batch, counted, trainer_mod):
    """The loss and every gradient of one training step's forward +
    backward through the kernels (model_k) and through the plain versions
    (model_p, same weights); launches of the kernel pass only."""
    from scp_tpu_torch.tools.profile_train import reset_counts

    dev = torch.device("cuda")
    data, pos, label = (torch.as_tensor(batch[k]).to(dev) for k in ("data", "pos", "label"))
    results = []
    for model, count in ((model_k, True), (model_p, False)):
        model.train()
        model.zero_grad(set_to_none=True)
        if count:
            reset_counts(counted.values())
        loss = trainer_mod.cross_entropy_bits(model(data, pos), label)
        loss.backward()
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counted.items()}
        results.append((float(loss.detach()), {n: p.grad for n, p in model.named_parameters()},
                        launches))
    (lk, gk, launches), (lp, gp, _) = results
    if not (math.isfinite(lk) and abs(lk - lp) <= LOSS_RTOL * abs(lp)):
        raise AssertionError(f"{name}: loss {lk} through the kernels vs {lp} plain")
    missing = [n for n, g in gk.items() if g is None or gp[n] is None]
    if missing:
        raise AssertionError(f"{name}: parameters without a gradient: {missing[:8]}")
    cos = {}
    for n, g in gk.items():
        a, b = g.double().flatten(), gp[n].double().flatten()
        na, nb = float(a.norm()), float(b.norm())
        if not math.isfinite(na):
            raise AssertionError(f"{name}: non-finite gradient of {n}")
        cos[n] = 1.0 if na == nb == 0.0 else float(a @ b) / max(na * nb, 1e-300)
    worst = min(cos, key=cos.get)
    n_zero = sum(1 for g in gk.values() if not bool(g.any()))
    say(f"  {name}: loss {lk:.6f} through the kernels, {lp:.6f} plain (rel diff "
        f"{abs(lk - lp) / abs(lp):.3g}); {len(gk)} parameters, all with gradients "
        f"({n_zero} all-zero); lowest gradient cosine {cos[worst]:.6f} ({worst}); "
        f"launches A/B/C/D/E {[launches[k] for k in 'ABCDE']}")
    if cos[worst] < GRAD_COSINE:
        bad = sorted((c, n) for n, c in cos.items() if c < GRAD_COSINE)
        raise AssertionError(f"{name}: gradient cosines under {GRAD_COSINE}: {bad[:8]}")
    return dict(loss=lk, loss_plain=lp, min_cosine=cos[worst], min_cosine_param=worst,
                launches=launches)


def training_phase(counted, slices):
    """Phase 7 (see the module docstring); returns its numbers."""
    import shutil

    from scp_tpu_torch.codec.ehem_codec import EHEMCodec
    from scp_tpu_torch.models.ehem import EHEM
    from scp_tpu_torch.tools.profile_train import profiled_step, reset_counts
    from scp_tpu_torch.tools.train_bench_ckpt import gen_shards, recipe_config
    from scp_tpu_torch.train import checkpoints
    from scp_tpu_torch.train import trainer as trainer_mod
    from scp_tpu_torch.train.data import ShardDataset
    from scp_tpu_torch.weights import load_into

    work = os.path.join(HERE, "chiprun_out", "phase7")
    shutil.rmtree(work, ignore_errors=True)
    try:
        t0 = time.time()
        shard_dir = os.path.join(work, "shards")
        gen_shards(shard_dir, 2, N_POINTS, LIDAR_LEVEL, seed_base=1000)
        gen_shards(shard_dir + "_val", 1, N_POINTS, LIDAR_LEVEL, seed_base=5000)
        cfg = recipe_config(shard_dir, 8, 8192, config_dir=os.path.join(HERE, "configs"))
        cfg.train.load_pretrain = CKPT
        ds = ShardDataset(cfg.data.root, 8192, 8, mode="ehem", vari_data_len=True, seed=42)
        fixed = next(ShardDataset(cfg.data.root, 8192, 8, mode="ehem").batches())
        val = next(ShardDataset(os.path.join(shard_dir + "_val", "*.npy"), 8192, 8,
                                mode="ehem", seed=7).batches())
        trainer = trainer_mod.Trainer(cfg, ds.steps_per_epoch(), device="cuda", static_knn=True)
        trainer.init_state()
        torch.cuda.synchronize()
        say(f"phase 7 setup: {time.time() - t0:.2f} s, {ds.total_nodes} training nodes in "
            f"{len(ds.files)} shards, {ds.steps_per_epoch()} steps/epoch, batch "
            f"{fixed['data'].shape}, warm from {os.path.basename(CKPT)}")
        out = {}

        def plain_twin(**switches):
            m = EHEM.from_config(cfg, torch.bfloat16, device="cuda", plain_seams=True,
                                 **switches)
            m.load_state_dict(trainer.model.state_dict())
            return m

        # 7a: the default configuration (A, B, C)
        t0 = time.time()
        out["7a"] = grad_check("7a gradients, default config", trainer.model,
                               plain_twin(static_knn=True), fixed, counted, trainer_mod)
        for k in "ABC":
            fn = counted[k]
            if not fn.launches or fn.arms["sm90"] != fn.launches:
                raise AssertionError(f"7a: kernel {k} launched {fn.launches} times, arms {fn.arms}")
        say(f"  7a: {time.time() - t0:.2f} s; Hopper arms {[counted[k].arms for k in 'ABC']}")

        # 7b: pallas_knn + pallas_attn on the batch cut to 2048 nodes (D, E)
        t0 = time.time()
        short = {k: v[:, :2048] for k, v in fixed.items()}
        sw = dict(static_knn=True, pallas_knn=True, pallas_attn=True)
        model_b = EHEM.from_config(cfg, torch.bfloat16, device="cuda", **sw)
        model_b.load_state_dict(trainer.model.state_dict())
        out["7b"] = grad_check("7b gradients, pallas_knn + pallas_attn, 2048 nodes", model_b,
                               plain_twin(**sw), short, counted, trainer_mod)
        if not (out["7b"]["launches"]["D"] and out["7b"]["launches"]["E"]):
            raise AssertionError(f"7b: D and E must launch: {out['7b']['launches']}")

        def step_b():
            model_b.zero_grad(set_to_none=True)
            data, pos, label = (torch.as_tensor(short[k]).to("cuda")
                                for k in ("data", "pos", "label"))
            trainer_mod.cross_entropy_bits(model_b(data, pos), label).backward()

        step_b()  # warm
        reset_counts(counted.values())
        out["profile_2048"] = profiled_step(step_b)
        out["launches_2048"] = {k: fn.launches for k, fn in counted.items()}
        del model_b
        say(f"  7b: {time.time() - t0:.2f} s")

        # 7c: 20 steps with vari_data_len
        gen = ds.batches()
        trainer.train_step(next(gen))  # warm (allocator, kernel loads)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls, losses, lengths, split = [], [], [], {}
        for _ in range(20):
            batch = next(gen)
            t = time.perf_counter()
            loss = float(trainer.train_step(batch, timings=split))
            walls.append(time.perf_counter() - t)
            losses.append(loss)
            lengths.append(batch["data"].shape[1])
        peak = torch.cuda.max_memory_allocated()
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"7c: non-finite loss: {losses}")
        total = sum(split.values())
        out["7c"] = dict(median_s_per_step=float(np.median(walls)), mean_s_per_step=sum(walls) / 20,
                         peak_memory_gb=peak / 1e9, lengths=lengths, losses=losses,
                         shares={k: v / total for k, v in split.items()})
        say(f"  7c: 20 steps, lengths {lengths}; losses {[round(x, 4) for x in losses]}; "
            f"median {out['7c']['median_s_per_step']:.4f} s/step (mean "
            f"{out['7c']['mean_s_per_step']:.4f}), peak memory {peak / 1e9:.2f} GB, shares "
            + ", ".join(f"{k} {v:.3f}" for k, v in out["7c"]["shares"].items()))
        t = time.perf_counter()
        trainer.train_step(fixed)
        torch.cuda.synchronize()
        out["7c"]["s_per_step_8192"] = time.perf_counter() - t
        reset_counts(counted.values())
        out["profile_8192"] = profiled_step(lambda: trainer.train_step(fixed))
        out["launches_8192"] = {k: fn.launches for k, fn in counted.items()}
        say(f"  7c: one (8, 8192) step {out['7c']['s_per_step_8192']:.4f} s; launches per step "
            f"A/B/C {[out['launches_8192'][k] for k in 'ABC']} (at 2048 with the switches, "
            f"D/E {[out['launches_2048'][k] for k in 'DE']})")
        for k, prof in (("A", "profile_8192"), ("B", "profile_8192"), ("C", "profile_8192"),
                        ("D", "profile_2048"), ("E", "profile_2048")):
            r = out[prof].get(k, {})
            say(f"  {k} per step ({prof[8:]} nodes): forward {r.get('forward_ms')} ms "
                f"x{r.get('forward_count')} (span {r.get('forward_span_ms')}), plain backward "
                f"{r.get('backward_ms')} ms x{r.get('backward_count')} (span "
                f"{r.get('backward_span_ms')})")

        # 7d: one repeated batch
        d_losses = [float(trainer.train_step(fixed)) for _ in range(10)]
        out["7d"] = dict(losses=d_losses)
        say(f"  7d: 10 steps on one batch, losses {[round(x, 4) for x in d_losses]}")
        if not d_losses[-1] < d_losses[0]:
            raise AssertionError(f"7d: the loss did not fall: {d_losses}")
        out["val_bits_per_node"] = trainer.evaluate([val])
        say(f"  validation (1 batch, seed 5000 cloud): {out['val_bits_per_node']:.4f} bits/node")

        # 7e: the trained weights through the npz and the codec's loader
        t0 = time.time()
        npz = os.path.join(work, "trained.npz")
        checkpoints.save_params_npz(npz, trainer.model)
        coded = load_into(EHEM(static_knn=True, dtype=torch.bfloat16, device="cuda"), npz)
        del trainer
        torch.cuda.empty_cache()
        p7 = roundtrip(EHEMCodec(coded, context_size=8192), slices, counted.values())
        out["7e"] = dict(bpp=p7["bpp"], bytes=p7["bytes"])
        say(f"  7e: trained weights -> npz -> codec: lossless, bpp={p7['bpp']:.4f}, "
            f"bytes={p7['bytes']} ({time.time() - t0:.2f} s)")
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---- phase 8: the codec CLI ----------------------------------------------------


def _octrees_equal(a, b) -> bool:
    import dataclasses

    return all(np.array_equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a))


def cli_phase(model, counted, p4):
    """Phase 8 (see the module docstring); returns its numbers.  `model` is
    phase 4's, for the in-process stream the CLI's payload must equal."""
    import shutil
    import tempfile

    from scp_tpu_torch.cli import decode as decode_cli
    from scp_tpu_torch.cli import encode as encode_cli
    from scp_tpu_torch.cli.codec_common import shard_name
    from scp_tpu_torch.codec.bitstream import unpack_stream
    from scp_tpu_torch.codec.ehem_codec import EHEMCodec
    from scp_tpu_torch.codec.slices import split_levels
    from scp_tpu_torch.config import load_config, save_config
    from scp_tpu_torch.core.pointcloud import read_points
    from scp_tpu_torch.core.preprocess import kitti_qs, preprocess_points
    from scp_tpu_torch.native import octree_native
    from scp_tpu_torch.tools.profile_train import reset_counts

    work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        # input: the bench sweep as a KITTI .bin (x, y, z, intensity f32)
        seq = os.path.join(work, "sequences", "00")
        os.makedirs(seq)
        cloud = os.path.join(seq, "000000.bin")
        pts = synth_kitti(np.random.default_rng(0), N_POINTS).astype(np.float32)
        np.hstack([pts, np.zeros((N_POINTS, 1), np.float32)]).tofile(cloud)
        run = os.path.join(work, "run")
        save_config(load_config("train_kitti_ehem.yaml", os.path.join(HERE, "configs")), run)
        ckpt = os.path.join(run, "ckpt", os.path.basename(CKPT))
        os.makedirs(os.path.dirname(ckpt))
        shutil.copyfile(CKPT, ckpt)

        # the native octree builder: built, and equal to the numpy builder
        t0 = time.time()
        if not octree_native.available():
            raise AssertionError("the native octree builder did not build")
        t_build = time.time() - t0
        read = read_points(cloud)
        pre = {}
        for tag, native in (("native", True), ("numpy", False)):
            t0 = time.perf_counter()
            res = preprocess_points(read, system="spher", qs=kitti_qs(LIDAR_LEVEL), native=native)
            pre[tag] = (res, time.perf_counter() - t0)
        (res, t_native), (res_np, t_numpy) = pre["native"], pre["numpy"]
        if not _octrees_equal(res.tree, res_np.tree):
            raise AssertionError("native OctreeArrays differ from the numpy builder's")
        say(f"  native octree: build + load {t_build:.2f} s; preprocess native "
            f"{t_native:.3f} s (octree {res.octree_s:.3f} s), numpy {t_numpy:.3f} s (octree "
            f"{res_np.octree_s:.3f} s); OctreeArrays equal ({res.tree.num_nodes} nodes)")

        # encode through the CLI
        out_dir = os.path.join(work, "bins")
        flags = ["--ckpt_path", ckpt, "--type", "kitti", "--static-knn", "--test_files", cloud]
        reset_counts(counted.values())
        octree_native.build_from_keys.calls = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (enc,) = encode_cli.main([*flags, "--lidar_level", str(LIDAR_LEVEL), "--spher",
                                  "--out_dir", out_dir])
        enc_wall = time.perf_counter() - t0
        native_calls = octree_native.build_from_keys.calls
        if not native_calls:
            raise AssertionError("the CLI's preprocessing did not take the native builder")

        # decode through the CLI, codes checked against the shard
        shards = os.path.join(work, "shards")
        os.makedirs(shards)
        np.save(os.path.join(shards, shard_name(cloud, "kitti")), res.context)
        t0 = time.perf_counter()
        (dec,) = decode_cli.main([*flags, "--preproc_path", shards, "--bin_dir", out_dir])
        dec_wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counted.items()}
        for k in "ABC":
            if not launches[k]:
                raise AssertionError(f"phase 8: kernel {k} never launched: {launches}")
        got = np.sort(dec["points"].astype(np.float64), axis=0)
        want = np.sort(res.recon_points.astype(np.float64), axis=0)
        if got.shape != want.shape or not np.allclose(got, want, rtol=0, atol=1e-4):
            raise AssertionError("phase 8: decoded points differ from the quantized cloud")

        # the CLI's payload is the codec's in-process stream of the file
        with open(enc["outputfile"], "rb") as fh:
            blob = fh.read()
        header, payload = unpack_stream(blob)
        codec = EHEMCodec(model, context_size=8192)
        if header.coding_params != codec.coding_params():
            raise AssertionError(f"phase 8: stamp {header.coding_params} != {codec.coding_params()}")
        slices = split_levels(res.context, angular=True, lidar_level_clip=LIDAR_LEVEL)
        stream, _, _ = codec.encode_to_stream(slices, lidar_clip=LIDAR_LEVEL)
        if stream != payload:
            raise AssertionError("phase 8: the CLI's payload differs from the in-process stream")
        if abs(enc["bpp"] - p4["bpp"]) > BPP_RTOL * p4["bpp"]:
            raise AssertionError(f"phase 8 bpp {enc['bpp']} is not within {BPP_RTOL} of "
                                 f"phase 4's {p4['bpp']}")
        et, dt = enc["timings"], dec["timings"]
        say(f"  encode CLI: wall {enc_wall:.3f} s; preprocess {et['preprocess']:.3f}, octree "
            f"{et['octree']:.3f}, model + coder {et['model_coder']:.3f}, metrics (PSNR D1, "
            f"chamfer) {et['metrics']:.3f}, file I/O {et['file_io']:.3f} s; bpp "
            f"{enc['bpp']:.4f}, {len(payload)} payload bytes, header {len(blob) - len(payload)} "
            f"bytes, PSNR D1 {enc['psnr_d1']:.4f} dB, chamfer {enc['chamfer']:.6f}")
        say(f"  decode CLI: wall {dec_wall:.3f} s; model + coder {dt['model_coder']:.3f}, "
            f"deoctree {dt['deoctree']:.3f}, file I/O {dt['file_io']:.3f} s; lossless against "
            f"the shard; launches A/B/C/D/E {[launches[k] for k in 'ABCDE']} (encode + decode)")
        return dict(bpp=enc["bpp"], payload_bytes=len(payload),
                    header_bytes=len(blob) - len(payload), psnr_d1=enc["psnr_d1"],
                    chamfer=enc["chamfer"], encode_wall_s=enc_wall, decode_wall_s=dec_wall,
                    encode_timings=et, decode_timings=dt, launches=launches,
                    native_octree_calls=native_calls, native_build_s=t_build,
                    preprocess_native_s=t_native, preprocess_numpy_s=t_numpy,
                    octree_native_s=res.octree_s, octree_numpy_s=res_np.octree_s)
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---- phase 9: OctAttention serving -------------------------------------------


def _profiled_largest_level(codec, ctx) -> dict:
    """The fused encode loop of the cloud's largest level (1024 positions
    over all its lanes): its host wall (ending in a sync), then the same
    loop under torch.profiler for its kernel launches and kernel time."""
    from torch.profiler import ProfilerActivity, profile

    levels, occ, max_level = codec.split_levels(ctx)
    sizes = [d.shape[0] for d, _ in levels]
    li = int(np.argmax(sizes))
    n = sizes[li]
    lanes = codec.max_lane_bucket(ctx)
    off = sum(sizes[:li])
    pos_int = ctx[ctx[:, -1, 1] == li + 1][:, :, 3:6].astype(np.int32)
    inputs = codec._fused_inputs(*codec._level_bufs(levels[li][0], pos_int, lanes),
                                 float(np.float32(1.0 / float(2**max_level))), lanes)
    ts = codec._true_syms(occ[off : off + n].astype(np.int64), n, lanes)
    positions = min(codec.csz, n)
    sync(codec.device)
    t0 = time.perf_counter()
    codec._rans_level(inputs, n, lanes, true_syms=ts)
    sync(codec.device)
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        codec._rans_level(inputs, n, lanes, true_syms=ts)
        sync(codec.device)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    # demangled: "void (anonymous namespace)::cached_attn_split<float>(...)"
    split = sum("cached_attn_split" in e.name for e in kernels)
    if codec.device.type == "cuda" and not split:
        raise AssertionError("phase 9b: the cached-attention kernel is not in the level's trace")
    return dict(level=li + 1, nodes=n, lanes=lanes, positions=positions,
                host_ms_per_position=1e3 * wall / positions,
                kernel_launches_per_position=len(kernels) / positions,
                cached_attn_launches_per_position=split / positions,
                kernel_ms_per_position=dev_ms / positions,
                idle_share=1.0 - dev_ms / (1e3 * wall))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def octattn_phase(device="cuda", n_points=N_POINTS, level=OCT_LEVEL,
                  window_level=WINDOW_LEVEL) -> dict:
    """Phase 9 (see the module docstring); returns its numbers.  The
    arguments serve a rehearsal of the phase on the CPU at a small size."""
    import shutil
    import tempfile

    from scp_tpu_torch.cli import decode as decode_cli
    from scp_tpu_torch.cli import encode as encode_cli
    from scp_tpu_torch.cli.codec_common import shard_name
    from scp_tpu_torch.codec.bitstream import unpack_stream
    from scp_tpu_torch.codec.octattn_codec import OctAttentionCodec
    from scp_tpu_torch.config import load_config, save_config
    from scp_tpu_torch.core.pointcloud import read_points
    from scp_tpu_torch.core.preprocess import kitti_qs, preprocess_points
    from scp_tpu_torch.models.octattention import OctAttention
    from scp_tpu_torch.native import ac_native
    from scp_tpu_torch.weights import load_into

    out = {}
    t0 = time.time()
    model = load_into(OctAttention(device=device), OCT_CKPT)
    cpu_model = load_into(OctAttention(device="cpu"), OCT_CKPT)
    # float32, as 9c's KITTI .bin holds it (the CLI's payload must equal 9b's)
    pts = synth_kitti(np.random.default_rng(0), n_points).astype(np.float32)
    res = preprocess_points(pts, system="spher", qs=kitti_qs(level))
    ctx = res.context
    codec = OctAttentionCodec(model)  # rans, fused
    levels, occ, max_level = codec.split_levels(ctx)
    sizes = [d.shape[0] for d, _ in levels]
    lanes = codec.max_lane_bucket(ctx)
    steps = sum(min(codec.csz, n) for n in sizes)
    say(f"phase 9 setup: {time.time() - t0:.2f} s; f32 OctAttention from "
        f"{os.path.basename(OCT_CKPT)}; {ctx.shape[0]} nodes in {len(sizes)} levels "
        f"(largest {max(sizes)}), {lanes} lanes, {steps} positions per direction; "
        "kernels A-E: 0 launches on this path (its one kernel is the cached attention)")
    out.update(nodes=int(ctx.shape[0]), levels=len(sizes), level_sizes=sizes, lanes=lanes,
               positions=steps)

    # ---- 9a: card vs CPU, KV-cache steps vs the window
    t0 = time.time()
    data, pos = levels[int(np.argmax(sizes))]
    d = torch.from_numpy(data[None, :1024].astype(np.int32))
    p = torch.from_numpy(pos[None, :1024])
    with torch.no_grad():
        full = model(d.to(device), p.to(device))
        full_cpu = cpu_model(d, p)
    err_cpu = check_close("9a card vs CPU window", full[0].cpu(), full_cpu[0], tol=F32_TOL)
    cache = model.init_cache(1)
    steps_logits = []
    for j in range(d.shape[1]):
        dj, pj = d[:, j].to(device), p[:, j].to(device)
        lg, qs = model.decode_step(dj, pj, cache, j)
        model.decode_insert(dj, pj, cache, j, qs)
        steps_logits.append(lg)
    err_kv = check_close("9a KV-cache steps vs window", torch.cat(steps_logits), full[0],
                         tol=F32_TOL)
    say(f"phase 9a: {time.time() - t0:.2f} s; 1024-row window of level "
        f"{int(np.argmax(sizes)) + 1}: card vs CPU max_abs_err {err_cpu:.3g}, KV-cache steps "
        f"vs window max_abs_err {err_kv:.3g} (atol = rtol = {F32_TOL})")
    out.update(err_card_vs_cpu=err_cpu, err_steps_vs_window=err_kv)

    # ---- 9b: fused device-rANS encode + decode in process
    from scp_tpu_torch.ops import cached_attn

    cached_attn.cached_attention.launches = 0  # counted over 9b's roundtrip alone
    model.step_replays = 0
    captured = len(model._graphs)
    sync(device)
    t0 = time.perf_counter()
    enc = codec.new_rans_encoder(lanes)
    t_loop = codec.encode_incremental_into(enc, ctx)
    ideal = enc.ideal_bits()
    payload = enc.finish()
    t_enc = time.perf_counter() - t0
    sync(device)
    t0 = time.perf_counter()
    dec = codec.new_rans_decoder(payload)
    codes = codec.decode_incremental_rans(dec, max_level, ground_truth=occ)
    sync(device)
    t_dec = time.perf_counter() - t0
    if not (codes == occ).all():
        raise AssertionError("phase 9b: decode is not lossless")
    # kernel K on the main path: every position of both directions replays
    # the model's step and insert, which launch it once a layer (the
    # insert's last layer attends nothing), as does the one eager run that
    # precedes each lane count's capture
    k_launches, replays = cached_attn.cached_attention.launches, model.step_replays
    k_per_position = 2 * model.num_layers - 1
    captured = len(model._graphs) - captured
    if device == "cuda" and not (
            replays == 2 * steps and k_launches == k_per_position * (replays + captured)):
        raise AssertionError(f"phase 9b: {replays} step replays for {2 * steps} "
                             f"positions, {captured} lane counts captured, {k_launches} "
                             "cached-attention launches")
    bits = len(payload) * 8
    slack = 32 * lanes + 16
    if not ideal <= bits <= ideal + slack:
        raise AssertionError(f"phase 9b: payload {bits} bits vs ideal {ideal:.1f} + {slack}")
    prof = _profiled_largest_level(codec, ctx)
    say(f"phase 9b fused rans: lossless, payload {bits} bits ({len(payload)} bytes), ideal "
        f"{ideal:.1f} bits, excess {bits - ideal:.1f} <= {slack}; bpp {bits / n_points:.4f}, "
        f"bits/node {bits / ctx.shape[0]:.4f}; encode {t_enc:.3f} s (level loops {t_loop:.3f} s), "
        f"decode {t_dec:.3f} s, {1e3 * t_loop / steps:.4f} ms host wall per encode position; "
        f"the largest level's encode loop (level {prof['level']}, {prof['lanes']} lanes, "
        f"{prof['positions']} positions): {prof['host_ms_per_position']:.4f} ms host wall, "
        f"{prof['kernel_launches_per_position']:.1f} kernel launches and "
        f"{prof['kernel_ms_per_position']:.4f} ms of kernels per position (idle share "
        f"{prof['idle_share']:.3f}), of them {prof['cached_attn_launches_per_position']:.1f} "
        f"cached-attention launches; kernel K {k_launches} launches in the roundtrip "
        f"(({replays} step replays + {captured} captures) x {k_per_position})")
    out.update(payload_bytes=len(payload), payload_bits=bits, ideal_bits=ideal,
               bpp=bits / n_points, encode_s=t_enc, encode_loop_s=t_loop, decode_s=t_dec,
               step_profile=prof, cached_attn_launches=k_launches)

    # ---- 9c: the CLIs
    work = tempfile.mkdtemp(prefix="chip_smoke_oct_")
    try:
        seq = os.path.join(work, "sequences", "00")
        os.makedirs(seq)
        cloud = os.path.join(seq, "000000.bin")
        np.hstack([pts, np.zeros((n_points, 1), np.float32)]).tofile(cloud)
        run = os.path.join(work, "run")
        save_config(load_config("train_kitti.yaml", os.path.join(HERE, "configs")), run)
        ckpt = os.path.join(run, "ckpt", os.path.basename(OCT_CKPT))
        os.makedirs(os.path.dirname(ckpt))
        shutil.copyfile(OCT_CKPT, ckpt)
        flags = ["--ckpt_path", ckpt, "--type", "kitti", "--test_files", cloud,
                 *(["--device", "cpu"] if device == "cpu" else [])]
        shards = os.path.join(work, "shards")
        os.makedirs(shards)
        cli = {}
        for tag, lv, extra in (("rans", level, ["--incremental"]),
                               ("window", window_level, [])):
            bins = os.path.join(work, f"bins_{tag}")
            ref = preprocess_points(read_points(cloud), system="spher", qs=kitti_qs(lv))
            np.save(os.path.join(shards, shard_name(cloud, "kitti")), ref.context)
            t0 = time.perf_counter()
            (e,) = encode_cli.main([*flags, "--lidar_level", str(lv), "--spher",
                                    "--out_dir", bins, *extra])
            enc_wall = time.perf_counter() - t0
            t0 = time.perf_counter()
            (dd,) = decode_cli.main([*flags, "--preproc_path", shards, "--bin_dir", bins])
            dec_wall = time.perf_counter() - t0
            got = np.sort(dd["points"].astype(np.float64), axis=0)
            want = np.sort(ref.recon_points.astype(np.float64), axis=0)
            if got.shape != want.shape or not np.allclose(got, want, rtol=0, atol=1e-4):
                raise AssertionError(f"phase 9c {tag}: decoded points differ from the cloud")
            with open(e["outputfile"], "rb") as fh:
                header, body = unpack_stream(fh.read())
            if tag == "rans" and body != payload:
                raise AssertionError("phase 9c: the CLI's payload differs from 9b's stream")
            et, dt = e["timings"], dd["timings"]
            say(f"  9c {tag} ({header.coding_mode}, L{lv}, {e['oct_num']} nodes): encode "
                f"wall {enc_wall:.3f} s (preprocess {et['preprocess']:.3f}, octree "
                f"{et['octree']:.3f}, model + coder {et['model_coder']:.3f}, metrics "
                f"{et['metrics']:.3f}, file I/O {et['file_io']:.3f}); decode wall "
                f"{dec_wall:.3f} s (model + coder {dt['model_coder']:.3f}, deoctree "
                f"{dt['deoctree']:.3f}, file I/O {dt['file_io']:.3f}); bpp {e['bpp']:.4f}, "
                f"{len(body)} payload bytes; lossless against the shard")
            cli[tag] = dict(level=lv, nodes=e["oct_num"], bpp=e["bpp"],
                            payload_bytes=len(body), encode_wall_s=enc_wall,
                            decode_wall_s=dec_wall, encode_timings=et, decode_timings=dt,
                            coding_mode=header.coding_mode, stamp=header.coding_params)
        if not ac_native.available():
            raise AssertionError("the native range coder did not build")
        say("  9c: the rans payload equals 9b's stream byte for byte; the window schedule "
            "ran on the native range coder (ac.cpp)")
        out["cli"] = cli
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


# ---- phase 10: OctAttention training --------------------------------------------

OCT_TRAIN_SEEDS = (1000, 1001, 1002)  # the synthetic KITTI sweeps 10b writes, disjoint from seed 0
OCT_CPU_BATCH = 4  # 10a: the CPU's side of the card-vs-CPU gradient check, 4 x 1024
OCT_TIMED_STEPS = 20
# 10a, card vs CPU in f32 (tests/test_torch_train_step.py's limits): summation order only
OCT_LOSS_RTOL = 1e-5
OCT_GRAD_TOL = 1e-4  # x max(1, the leaf's largest magnitude)
# The key projection's bias adds q.b to every score of a query's row, which
# softmax cancels: its gradient is 0 in exact arithmetic, and the f32 and
# bf16 steps compute rounding noise there, whose cosine means nothing.  10a
# holds those tensors to rounding level in f32 instead of to GRAD_COSINE.
GRADIENT_FREE = "attn.key.bias"
GRADIENT_FREE_NORM = 1e-5  # x the largest f32 gradient norm of any tensor


def _octattn_grads(model, batch, device):
    from scp_tpu_torch.train.trainer import cross_entropy_bits

    data, pos, label = (torch.as_tensor(batch[k]).to(device) for k in ("data", "pos", "label"))
    model.train()
    model.zero_grad(set_to_none=True)
    loss = cross_entropy_bits(model(data, pos), label)
    loss.backward()
    sync(device)
    return float(loss.detach()), {n: p.grad for n, p in model.named_parameters()}


def octattn_grad_checks(cfg, fixed, device) -> dict:
    """10a: one fixed batch at dropout 0, the warm-started model of `cfg`:
    the card's f32 loss and gradients against the CPU's f32 (the batch cut
    to OCT_CPU_BATCH rows), then the card's bf16 step against its f32 step
    on the whole batch."""
    from scp_tpu_torch.models import build_model
    from scp_tpu_torch.train.trainer import Trainer

    out = {}
    t32 = Trainer(cfg, 1, device=device)
    t32.init_state()
    m32 = t32.model
    cpu = build_model(cfg, torch.float32, device="cpu")
    cpu.load_state_dict(m32.state_dict())
    cut = {k: v[:OCT_CPU_BATCH] for k, v in fixed.items()}
    t0 = time.time()
    l_card, g_card = _octattn_grads(m32, cut, device)
    l_cpu, g_cpu = _octattn_grads(cpu, cut, "cpu")
    worst, worst_name = 0.0, None
    for n, want in g_cpu.items():
        got = g_card[n].cpu()
        bound = OCT_GRAD_TOL * max(1.0, float(want.abs().max()))
        excess = float(((got - want).abs() - OCT_GRAD_TOL * want.abs()).max()) / bound
        if excess > worst or worst_name is None:
            worst, worst_name = excess, n
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    say(f"  10a card vs CPU, f32, batch {tuple(cut['data'].shape[:2])}: loss {l_card:.7f} / "
        f"{l_cpu:.7f} (rel diff {rel:.3g}, limit {OCT_LOSS_RTOL}); worst gradient leaf "
        f"{worst_name} at {worst:.3g} of its limit ({OCT_GRAD_TOL} x max(1, largest)) "
        f"({time.time() - t0:.2f} s)")
    if not rel <= OCT_LOSS_RTOL or worst > 1.0:
        raise AssertionError(f"10a: card vs CPU loss rel {rel}, gradient {worst_name} at {worst}")
    out.update(card_vs_cpu_loss_rel=rel, card_vs_cpu_worst_leaf=worst_name,
               card_vs_cpu_worst_share_of_limit=worst, cpu_batch=OCT_CPU_BATCH)
    del cpu, g_cpu, g_card

    t0 = time.time()
    m16 = build_model(cfg, torch.bfloat16, device=device)
    m16.load_state_dict(m32.state_dict())
    l32, g32 = _octattn_grads(m32, fixed, device)
    l16, g16 = _octattn_grads(m16, fixed, device)
    missing = [n for n, g in g16.items() if g is None]
    if missing:
        raise AssertionError(f"10a: parameters without a gradient: {missing}")
    largest = max(float(g.double().norm()) for g in g32.values())
    cos, free = {}, {}
    for n, g in g16.items():
        a, b = g.double().flatten(), g32[n].double().flatten()
        if not math.isfinite(float(a.norm())):
            raise AssertionError(f"10a: non-finite bf16 gradient of {n}")
        if n.endswith(GRADIENT_FREE):
            free[n] = float(b.norm()) / largest
            continue
        cos[n] = float(a @ b) / max(float(a.norm()) * float(b.norm()), 1e-300)
    worst = min(cos, key=cos.get)
    rel = abs(l16 - l32) / abs(l32)
    say(f"  10a bf16 vs f32 on the card, batch {tuple(fixed['data'].shape[:2])}: loss "
        f"{l16:.6f} / {l32:.6f} (rel diff {rel:.3g}, limit {LOSS_RTOL}); {len(g16)} parameters, "
        f"all with gradients; lowest cosine {cos[worst]:.6f} ({worst}); the key biases' f32 "
        f"gradient norms / the largest: {max(free.values()):.3g} (limit {GRADIENT_FREE_NORM}) "
        f"({time.time() - t0:.2f} s)")
    if not rel <= LOSS_RTOL:
        raise AssertionError(f"10a: bf16 loss {l16} vs f32 {l32}")
    if cos[worst] < GRAD_COSINE:
        raise AssertionError(f"10a: gradient cosines under {GRAD_COSINE}: "
                             f"{sorted((c, n) for n, c in cos.items() if c < GRAD_COSINE)[:8]}")
    if len(free) != m32.num_layers or max(free.values()) > GRADIENT_FREE_NORM:
        raise AssertionError(f"10a: the key biases' gradients are not at rounding level: {free}")
    out.update(bf16_vs_f32_loss_rel=rel, min_cosine=cos[worst], min_cosine_param=worst,
               key_bias_grad_norm_share=max(free.values()))
    return out


def octattn_training_phase() -> dict:
    """Phase 10 (see the module docstring); returns its numbers."""
    import glob
    import shutil

    from scp_tpu_torch.cli import decode as decode_cli
    from scp_tpu_torch.cli import encode as encode_cli
    from scp_tpu_torch.cli import train as train_cli
    from scp_tpu_torch.cli.codec_common import shard_name
    from scp_tpu_torch.config import load_config
    from scp_tpu_torch.core.pointcloud import read_points
    from scp_tpu_torch.core.preprocess import kitti_qs, preprocess_points
    from scp_tpu_torch.tools.profile_train import kernel_profile, timed_steps
    from scp_tpu_torch.train import checkpoints
    from scp_tpu_torch.train.data import ShardDataset

    out = {}
    dev = torch.device("cuda")
    work = os.path.join(HERE, "chiprun_out", "phase10")
    shutil.rmtree(work, ignore_errors=True)
    try:
        # ---- 10b: the data CLIs (run first: 10a and 10c read their shards)
        t0 = time.time()
        velodyne = os.path.join(work, "kitti", "sequences", "00", "velodyne")
        os.makedirs(velodyne)
        for i, seed in enumerate(OCT_TRAIN_SEEDS):
            pts = synth_kitti(np.random.default_rng(seed), N_POINTS).astype(np.float32)
            np.hstack([pts, np.zeros((N_POINTS, 1), np.float32)]).tofile(
                os.path.join(velodyne, f"{i:06d}.bin"))
        shards = os.path.join(work, "shards")
        cmd = [sys.executable, "-m", "scp_tpu_torch.tools.multi_preproc", "2",
               sys.executable, "-m", "scp_tpu_torch.tools.preprocess", "--type", "kitti",
               "--spher", "--ori_dir", os.path.join(velodyne, "*.bin"), "--out_dir", shards]
        env = {**os.environ, "PYTHONPATH": HERE}

        def run_clis():
            t = time.perf_counter()
            proc = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True, text=True,
                                  timeout=600)
            if proc.returncode:
                raise AssertionError(f"10b: multi_preproc exit {proc.returncode}: "
                                     f"{proc.stderr[-2000:]}")
            return proc.stdout, time.perf_counter() - t

        _, t_first = run_clis()
        files = sorted(glob.glob(os.path.join(shards, "*.npy")))
        stamps = {f: os.stat(f).st_mtime_ns for f in files}
        second, t_second = run_clis()
        skipped = second.count("Already exists")
        names = sorted(os.path.basename(f).rsplit("_", 1)[0] for f in files)
        if names != [f"00{i:06d}" for i in range(len(OCT_TRAIN_SEEDS))]:
            raise AssertionError(f"10b: shards {files}")
        if skipped != len(files) or {f: os.stat(f).st_mtime_ns for f in files} != stamps:
            raise AssertionError(f"10b: the second run skipped {skipped} of {len(files)}")
        first = preprocess_points(read_points(os.path.join(velodyne, "000000.bin")),
                                  system="spher", qs=400 / (2**16 - 1)).context
        if not np.array_equal(np.load(files[0]), first):
            raise AssertionError("10b: the first shard differs from preprocess_points")
        rows = [int(f.rsplit("_", 1)[1][:-4]) for f in files]
        say(f"phase 10b data CLIs: multi_preproc 2 x preprocess --type kitti --spher on "
            f"{len(files)} sweeps of {N_POINTS} points: {t_first:.2f} s, shards "
            f"{[os.path.basename(f) for f in files]}; the second run skipped all "
            f"{skipped} in {t_second:.2f} s; the first shard equals preprocess_points's "
            f"({time.time() - t0:.2f} s)")
        out["10b"] = dict(shards=[os.path.basename(f) for f in files], rows=rows,
                          first_run_s=t_first, second_run_s=t_second, skipped=skipped)

        root = os.path.join(shards, "*.npy")
        base = [f"data.root={root}", f"train.load_pretrain={OCT_CKPT}"]
        configs = os.path.join(HERE, "configs")
        cfg = load_config("train_kitti.yaml", configs, [*base, "bf16=False"])
        csz, batch = int(cfg.data.context_size), int(cfg.data.batch_size)
        fixed = next(ShardDataset(root, csz, batch, mode="octattn").batches())

        # ---- 10a: gradients at dropout 0
        t0 = time.time()
        out["10a"] = octattn_grad_checks(cfg, fixed, dev)
        say(f"phase 10a gradients: {time.time() - t0:.2f} s")

        # ---- 10c: cli.train.main on the shards, one epoch, dropout 0.1
        t0 = time.time()
        run = os.path.join(work, "run")
        trainer = train_cli.main([
            "--config-name", "train_kitti.yaml", "--config-dir", configs, "--run-dir", run,
            *base, "train.epoch=1", "train.dropout=0.1"])
        sync(dev)
        t_cli = time.time() - t0
        with open(os.path.join(run, "metrics.jsonl")) as fh:
            recs = [json.loads(line) for line in fh]
        losses = [r["train_loss"] for r in recs if "train_loss" in r]
        final = checkpoints.latest_checkpoint(run)
        if not losses or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"10c: logged losses {losses}")
        with open(os.path.join(run, "ckpt", "latest.txt")) as fh:
            if os.path.join(run, "ckpt", fh.read().strip()) != final or not os.path.exists(final):
                raise AssertionError(f"10c: no final checkpoint in {run}")
        say(f"phase 10c cli.train: {trainer.steps_per_epoch} steps of "
            f"{tuple(fixed['data'].shape[:2])} "
            f"in {t_cli:.2f} s (setup, validation batches and checkpoints included); logged "
            f"losses {[round(x, 4) for x in losses]}; {os.path.basename(final)} written")
        out["10c"] = dict(steps=trainer.step, cli_wall_s=t_cli, logged_losses=losses,
                          checkpoint=os.path.basename(final))
        p_run = trainer.model.dropout
        for p in (p_run, 0.0):  # the CLI's run, then the configs' default
            trainer.model.dropout = p
            timed = timed_steps(trainer, fixed, OCT_TIMED_STEPS)
            say(f"  10c {OCT_TIMED_STEPS} steps at dropout {p}: median "
                f"{timed['median_s_per_step']:.4f} s/step, peak memory "
                f"{timed['peak_memory_gb']:.2f} GB, shares "
                + ", ".join(f"{k} {v:.3f}" for k, v in timed["shares"].items()))
            out["10c"][f"timed_dropout_{p}"] = {k: v for k, v in timed.items() if k != "losses"}
        trainer.model.dropout = p_run
        prof = kernel_profile(lambda: trainer.train_step(fixed),
                              out["10c"][f"timed_dropout_{p_run}"]["median_s_per_step"])
        say(f"  10c one profiled step (dropout {p_run}): {prof['device_kernel_ms']:.1f} ms of "
            f"kernels, idle share {prof['device_idle_share']:.3f}; largest: "
            + "; ".join(f"{t['ms']:.2f} ms x{t['count']} {t['name'][:60]}"
                        for t in prof["top_kernels"][:8]))
        out["10c"]["profile"] = prof
        repeated = [float(trainer.train_step(fixed)) for _ in range(10)]
        say(f"  10c 10 steps on one batch: losses {[round(x, 4) for x in repeated]}")
        if not repeated[-1] < repeated[0]:
            raise AssertionError(f"10c: the loss did not fall: {repeated}")
        out["10c"]["repeated_losses"] = repeated
        del trainer
        torch.cuda.empty_cache()

        # ---- 10d: the trained run dir through the codec CLI
        t0 = time.time()
        seq = os.path.join(work, "bench", "sequences", "00")
        os.makedirs(seq)
        cloud = os.path.join(seq, "000000.bin")
        pts = synth_kitti(np.random.default_rng(0), N_POINTS).astype(np.float32)
        np.hstack([pts, np.zeros((N_POINTS, 1), np.float32)]).tofile(cloud)
        ref = preprocess_points(read_points(cloud), system="spher", qs=kitti_qs(OCT_LEVEL))
        ref_dir = os.path.join(work, "bench_shards")
        os.makedirs(ref_dir)
        np.save(os.path.join(ref_dir, shard_name(cloud, "kitti")), ref.context)
        flags = ["--ckpt_path", final, "--type", "kitti", "--test_files", cloud]
        bins = os.path.join(work, "bins")
        t = time.perf_counter()
        (e,) = encode_cli.main([*flags, "--lidar_level", str(OCT_LEVEL), "--spher", "--out_dir",
                                bins, "--incremental"])
        enc_wall = time.perf_counter() - t
        t = time.perf_counter()
        (d,) = decode_cli.main([*flags, "--preproc_path", ref_dir, "--bin_dir", bins])
        dec_wall = time.perf_counter() - t
        got = np.sort(d["points"].astype(np.float64), axis=0)
        want = np.sort(ref.recon_points.astype(np.float64), axis=0)
        if got.shape != want.shape or not np.allclose(got, want, rtol=0, atol=1e-4):
            raise AssertionError("10d: decoded points differ from the cloud")
        say(f"phase 10d the trained run through cli.encode --incremental / cli.decode "
            f"(L{OCT_LEVEL}, "
            f"{e['oct_num']} nodes): lossless; bpp {e['bpp']:.4f} (one epoch on L16 shards: "
            f"no rate claim), encode wall {enc_wall:.3f} s, decode wall {dec_wall:.3f} s "
            f"({time.time() - t0:.2f} s)")
        out["10d"] = dict(level=OCT_LEVEL, nodes=e["oct_num"], bpp=e["bpp"], encode_wall_s=enc_wall,
                          decode_wall_s=dec_wall)
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---- phase 11: EHEM's staged and full modes, the evaluation pipeline ---------

# staged vs full bits: scp_tpu's own bound for the staged rate against the
# single-stage rate (tests/test_staged.py).  The factorization is exact, but
# the two quantize differently: staged's ramps take 32 of 65,536 slots per
# node against full's 255, while a symbol the model all but rules out costs
# at most 16 bits in full mode and up to 32 when staged
MODES_RTOL = 2e-2
# each host-coder mode vs the ideal bits of the rans mode's coded symbols,
# sum(-log2(freq / 65536)) of phase 4's configuration: its payload adds the
# rANS lanes' final states (up to 32 bits each, 1024 lanes), which the
# arithmetic coder does not write.  What remains: the levels of <= 512
# nodes (the model here, a uniform prior in rans mode), each level's
# partial chunk (an 8192 or 1024 bucket here, the tail-merge plan's pow2
# bucket in rans mode: other pad rows beside the real ones) and the
# arithmetic coder's own overhead
RANS_RTOL = 1e-2
METRICS_RTOL = 1e-9  # native KD-tree vs scipy: D1, D2, Chamfer (summation order only)


class PhaseCalls:
    """Counts the kernel launches of A, B and C inside every phase call of
    a model (decode_phase1 / decode_phase2 wrapped on the instance)."""

    def __init__(self, model, counted):
        self.model, self.counted, self.calls = model, counted, []

    def _wrap(self, name, fn):
        def run(*args, **kwargs):
            before = {k: self.counted[k].launches for k in "ABC"}
            out = fn(*args, **kwargs)
            self.calls.append((name, tuple(args[0].shape[:2]),
                               {k: self.counted[k].launches - before[k] for k in "ABC"}))
            return out
        return run

    def __enter__(self):
        self.model.decode_phase1 = self._wrap("p1", self.model.decode_phase1)
        self.model.decode_phase2 = self._wrap("p2", self.model.decode_phase2)
        return self

    def __exit__(self, *exc):
        del self.model.decode_phase1, self.model.decode_phase2

    def check(self, tag):
        """Every phase-1 call launched A and B, every phase-2 call A and C."""
        need = {"p1": "AB", "p2": "AC"}
        bad = [c for c in self.calls if any(not c[2][k] for k in need[c[0]])]
        if not self.calls or bad:
            raise AssertionError(f"{tag}: phase calls without their kernels: {bad[:5]} "
                                 f"of {len(self.calls)}")
        return {k: sum(1 for c in self.calls if c[0] == k) for k in ("p1", "p2")}


def rans_ideal_bits(model, slices):
    """(payload bits, ideal bits) of a rans-mode encode of `slices`: the
    ideal bits are sum(-log2(freq / 65536)) over the coded symbols."""
    from scp_tpu_torch.codec.ehem_codec import EHEMCodec

    codec = EHEMCodec(model, context_size=8192)
    enc = codec.new_stream_encoder()
    ideal, append = [0.0], enc.append_group

    def counting(sf, n):
        ideal[0] += float(-torch.log2(sf[:n, 1].double() / 65536.0).sum())
        return append(sf, n)

    enc.append_group = counting
    codec.encode_into(enc, slices)
    _, bits, _ = codec.finish_stream(enc)
    return bits, ideal[0]


def host_modes_roundtrip(model, mode, slices, counted):
    """11a: one encode and one decode of `slices` in `mode` with the
    lossless check; counts reset just before, read just after."""
    from scp_tpu_torch.codec.ehem_codec import EHEMCodec
    from scp_tpu_torch.tools.profile_train import reset_counts

    codec = EHEMCodec(model, context_size=8192, mode=mode)
    torch.cuda.synchronize()
    reset_counts(counted.values())
    with PhaseCalls(model, counted) as pc:
        t0 = time.perf_counter()
        stream, bits, _ = codec.encode_to_stream(slices)
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        enc_timers, enc_report = dict(codec.timers.totals), codec.timers.report()
        codec.timers.clear()
        t0 = time.perf_counter()
        dec = codec.new_stream_decoder(stream, codec.ac_symbols_per_node * len(slices.occ_stream),
                                       coding_params=codec.coding_params())
        codes = codec.decode(dec, slices.max_level, np.array(slices.pos_mm, np.int64),
                             angular=True, ground_truth=slices.occ_stream,
                             level_sizes=slices.level_sizes)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counted.items()}
    if codes.shape != slices.occ_stream.shape or not (codes == slices.occ_stream).all():
        raise AssertionError(f"phase 11a {mode}: decode is not lossless")
    calls = pc.check(f"phase 11a {mode}")
    if launches["D"] or launches["E"]:
        raise AssertionError(f"phase 11a {mode}: D or E launched with their switches off")
    coder = codec.timers.totals.get("ac_decode", 0.0)
    return dict(bits=bits, bpp=bits / N_POINTS,
                bytes=len(stream), encode_s=t_enc, decode_s=t_dec,
                decode_host_coder_s=coder, decode_model_fetch_s=t_dec - coder,
                encode_host_coder_s=enc_timers.get("ac_encode", 0.0),
                encode_timers=enc_report, decode_timers=codec.timers.report(),
                launches=launches, phase_calls=calls)


def _metrics_both(ref, quant, normals):
    """The native KD-tree's D1/D2 PSNR and Chamfer against scipy's path on
    the same clouds; both times."""
    from scp_tpu_torch import metrics

    out = {}
    for tag, native in (("native", True), ("scipy", False)):
        t0 = time.perf_counter()
        d1, d2 = metrics.d1_d2_psnr(ref, quant, metrics.PEAKS["kitti"], normals, native=native)
        cd = metrics.chamfer(ref, quant, native=native)
        out[tag] = dict(d1=float(d1), d2=float(d2), chamfer=float(cd),
                        s=time.perf_counter() - t0)
    for k in ("d1", "d2", "chamfer"):
        a, b = out["native"][k], out["scipy"][k]
        if not (math.isfinite(a) and abs(a - b) <= METRICS_RTOL * abs(b)):
            raise AssertionError(f"phase 11b: native {k} {a} vs scipy {b}")
    return out


def host_modes_phase(model, counted, slices, p4, p8_metrics):
    """Phase 11 (see the module docstring); returns its numbers.  `model`
    and `slices` are phase 4's; `p8_metrics` is (phase 8's metrics stage
    seconds, the native metric calls it made)."""
    import shutil
    import tempfile

    from scp_tpu_torch.cli import decode as decode_cli
    from scp_tpu_torch.cli import encode as encode_cli
    from scp_tpu_torch.codec.bitstream import unpack_stream
    from scp_tpu_torch.codec.ehem_codec import EHEMCodec
    from scp_tpu_torch.codec.slices import split_levels
    from scp_tpu_torch.config import load_config, save_config
    from scp_tpu_torch.core.pointcloud import read_points
    from scp_tpu_torch.metrics import estimate_normals
    from scp_tpu_torch.native import metrics_native
    from scp_tpu_torch.tools import gene_normals, psnr_test, test_gene
    from scp_tpu_torch.tools.profile_train import reset_counts

    out = {}
    # ---- 11a: in-process roundtrips of phase 4's slices
    t0 = time.time()
    for mode in ("staged", "full"):
        r = host_modes_roundtrip(model, mode, slices, counted)
        out[mode] = r
        say(f"phase 11a {mode}: lossless, bpp={r['bpp']:.4f} (rans {p4['bpp']:.4f}), "
            f"bytes={r['bytes']}, encode {r['encode_s']:.3f} s (host coder "
            f"{r['encode_host_coder_s']:.3f}), decode {r['decode_s']:.3f} s = model + fetch "
            f"{r['decode_model_fetch_s']:.3f} + host coder {r['decode_host_coder_s']:.3f}; "
            f"phase calls {r['phase_calls']}; launches A/B/C/D/E "
            f"{[r['launches'][k] for k in 'ABCDE']}")
        say(f"  {mode} encode timers: {r['encode_timers']}")
        say(f"  {mode} decode timers: {r['decode_timers']}")
    staged, full = out["staged"], out["full"]
    if abs(staged["bits"] - full["bits"]) > MODES_RTOL * full["bits"]:
        raise AssertionError(f"phase 11a: staged {staged['bits']} bits vs full {full['bits']}")
    rans_bits, rans_ideal = rans_ideal_bits(model, slices)
    if rans_bits != p4["bytes"] * 8:
        raise AssertionError(f"phase 11a: rans {rans_bits} bits, phase 4 {p4['bytes'] * 8}")
    # full codes the rans mode's own rows; staged may add MODES_RTOL to that
    for mode, tol in (("staged", RANS_RTOL + MODES_RTOL), ("full", RANS_RTOL)):
        out[mode]["vs_rans_ideal"] = out[mode]["bits"] / rans_ideal - 1
        if abs(out[mode]["bits"] - rans_ideal) > tol * rans_ideal:
            raise AssertionError(f"phase 11a: {mode} {out[mode]['bits']} bits vs the rans "
                                 f"symbols' ideal {rans_ideal:.1f}")
    say(f"  staged / full bits {staged['bits']} / {full['bits']} "
        f"({staged['bits'] / full['bits'] - 1:+.5f}); rans payload {rans_bits} bits, its "
        f"symbols' ideal {rans_ideal:.1f} (lane states {rans_bits - rans_ideal:.1f}); "
        f"staged / full vs that ideal {out['staged']['vs_rans_ideal']:+.5f} / "
        f"{out['full']['vs_rans_ideal']:+.5f}")
    say(f"phase 11a: {time.time() - t0:.2f} s")

    # ---- 11b: test_gene -> cli.encode -> cli.decode -> psnr_test
    t0 = time.time()
    base = os.path.join(HERE, "chiprun_out")
    os.makedirs(base, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_eval_", dir=base)
    try:
        seq = os.path.join(work, "sequences", "00")
        os.makedirs(seq)
        cloud = os.path.join(seq, "000000.bin")
        pts = synth_kitti(np.random.default_rng(0), N_POINTS).astype(np.float32)
        np.hstack([pts, np.zeros((N_POINTS, 1), np.float32)]).tofile(cloud)
        run = os.path.join(work, "run")
        save_config(load_config("train_kitti_ehem.yaml", os.path.join(HERE, "configs")), run)
        ck = os.path.join(run, "ckpt", os.path.basename(CKPT))
        os.makedirs(os.path.dirname(ck))
        shutil.copyfile(CKPT, ck)

        pre = os.path.join(work, "pre")
        t1 = time.perf_counter()
        test_gene.main(["--type", "kitti", "--ori_dir", cloud, "--out_dir", pre,
                        "--lidar_level", str(LIDAR_LEVEL), "--spher"])
        t_gene = time.perf_counter() - t1
        name = "00000000"
        for suffix in (".npy", "_quant.ply", "_meta.npy", "_manifest.npz"):
            if not os.path.exists(os.path.join(pre, name + suffix)):
                raise AssertionError(f"phase 11b: test_gene wrote no {name + suffix}")
        ctx = np.load(os.path.join(pre, name + ".npy"))
        meta = np.load(os.path.join(pre, name + "_meta.npy"))
        say(f"  test_gene: {t_gene:.3f} s; shard {ctx.shape}, meta bin_num {int(meta[0])}, "
            f"chamfer {meta[1]:.6f}")

        flags = ["--ckpt_path", ck, "--type", "kitti", "--static-knn", "--test_files", cloud]
        sl_cli = split_levels(ctx, angular=True, lidar_level_clip=LIDAR_LEVEL)
        for mode in ("staged", "full"):
            bins = os.path.join(work, f"bins_{mode}")
            reset_counts(counted.values())
            t1 = time.perf_counter()
            (enc,) = encode_cli.main([*flags, "--lidar_level", str(LIDAR_LEVEL), "--spher",
                                      "--preproc_path", pre + "/", "--ehem-mode", mode,
                                      "--out_dir", bins])
            enc_wall = time.perf_counter() - t1
            t1 = time.perf_counter()
            (dec,) = decode_cli.main([*flags, "--preproc_path", pre, "--bin_dir", bins])
            dec_wall = time.perf_counter() - t1
            launches = {k: fn.launches for k, fn in counted.items()}
            if not all(launches[k] for k in "ABC"):
                raise AssertionError(f"phase 11b {mode}: A, B or C never launched: {launches}")
            quant = read_points(os.path.join(pre, name + "_quant.ply"))
            got = np.sort(dec["points"].astype(np.float64), axis=0)
            want = np.sort(quant.astype(np.float64), axis=0)
            if got.shape != want.shape or not np.allclose(got, want, rtol=0, atol=1e-4):
                raise AssertionError(f"phase 11b {mode}: decoded points differ from _quant.ply")
            with open(enc["outputfile"], "rb") as fh:
                header, payload = unpack_stream(fh.read())
            if header.coding_mode != mode:
                raise AssertionError(f"phase 11b: header mode {header.coding_mode} != {mode}")
            # the payload is the in-process stream of the shard's slices
            # (the .bin's float32 points give another octree than phase
            # 4's float64 sweep, so 11a's stream is not the reference)
            want_stream, _, _ = EHEMCodec(model, context_size=8192, mode=mode).encode_to_stream(
                sl_cli, lidar_clip=LIDAR_LEVEL)
            if payload != want_stream:
                raise AssertionError(f"phase 11b {mode}: the CLI's payload differs from the "
                                     "in-process stream")
            et, dt = enc["timings"], dec["timings"]
            say(f"  cli {mode}: encode wall {enc_wall:.3f} s (model + coder "
                f"{et['model_coder']:.3f}, file I/O {et['file_io']:.3f}), decode wall "
                f"{dec_wall:.3f} s (model + coder {dt['model_coder']:.3f}, deoctree "
                f"{dt['deoctree']:.3f}); bpp {enc['bpp']:.4f}, lossless against the shard, "
                f"payload = in-process stream; launches A/B/C {[launches[k] for k in 'ABC']}")
            out[f"cli_{mode}"] = dict(encode_wall_s=enc_wall, decode_wall_s=dec_wall,
                                      bpp=enc["bpp"], encode_timings=et, decode_timings=dt,
                                      launches=launches)

        # psnr_test on the _quant.ply, with the original's normals (D2)
        ref = read_points(cloud)
        t1 = time.perf_counter()
        normals = estimate_normals(ref)
        t_normals = time.perf_counter() - t1
        ndir = os.path.join(work, "normals", "00")
        gene_normals.write_ply_with_normals(os.path.join(ndir, "000000.ply"), ref, normals)
        t1 = time.perf_counter()
        printed = psnr_test.main(["--type", "kitti", "--ori_dir",
                                  os.path.join(ndir, "000000.ply"), "--quant_dir", pre,
                                  "--with_normals"])
        t_psnr = time.perf_counter() - t1
        if len(printed["d1"]) != 1 or not (np.isfinite(printed["d1"]).all()
                                           and np.isfinite(printed["d2"]).all()):
            raise AssertionError(f"phase 11b: psnr_test printed {printed}")
        # the native metrics against scipy's path on the sweep and its
        # quantized cloud
        both = _metrics_both(ref, read_points(os.path.join(pre, name + "_quant.ply")), normals)
        if not metrics_native.available():
            raise AssertionError("phase 11b: metrics_native did not build")
        p8_s, p8_calls = p8_metrics
        if not p8_calls:
            raise AssertionError("phase 8's metrics stage made no native call")
        n, sp = both["native"], both["scipy"]
        say(f"  psnr_test --with_normals: D1 {printed['d1'][0]:.4f} D2 {printed['d2'][0]:.4f} "
            f"chamfer {printed['chamfer'][0]:.6f} in {t_psnr:.3f} s; normals (native k-NN, k=30) "
            f"{t_normals:.3f} s")
        say(f"  metrics native vs scipy: D1 {n['d1']!r} / {sp['d1']!r}, D2 {n['d2']!r} / "
            f"{sp['d2']!r}, chamfer {n['chamfer']!r} / {sp['chamfer']!r}; time native "
            f"{n['s']:.3f} s, scipy {sp['s']:.3f} s")
        say(f"  phase 8's metrics stage on the native KD-tree: {p8_s:.3f} s "
            f"({p8_calls} native calls)")
        out.update(test_gene_s=t_gene, psnr_test_s=t_psnr, normals_s=t_normals,
                   psnr_test=printed, metrics=both, phase8_metrics_s=p8_s,
                   phase8_native_calls=p8_calls)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    say(f"phase 11b: {time.time() - t0:.2f} s")
    return out


# ---- phase 12: data-parallel training and multi-device coding ----------------

# the P-rank step against the one-rank step on the same global batches: f32
# at tests/test_torch_train_step.py's limits (summation order: the
# all-reduce's and cuBLAS's choice for a smaller M), bf16 at phase 7a's
DP_LOSS_RTOL_F32 = 1e-5
DP_GRAD_TOL_F32 = 1e-4  # x max(1, the leaf's largest magnitude)
DP_STATS_TOL_F32 = 1e-5
DP_STATS_TOL_BF16 = 1e-2  # x max(1, |statistic|): bf16 activations, other sum order
DP_TIMED_STEPS = 5
DP_JOIN_S = 600  # a rank that outlives this fails the phase


def dp_world():
    """(ranks, backend) of 12a: one rank per card over NCCL, or two ranks
    on the one card over gloo (NCCL refuses two ranks on one card)."""
    n = torch.cuda.device_count()
    return (2, "gloo") if n == 1 else (n, "nccl")


def _cosine(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    na, nb = float(a.norm()), float(b.norm())
    return 1.0 if na == nb == 0.0 else float(a @ b) / max(na * nb, 1e-300)


def dp_compare(name, one, ranks, f32: bool, kernels: str = "ABC") -> dict:
    """The world's step against the one-rank step: loss, gradients, the
    replicated update and the BatchNorm statistics on every rank; the
    kernels `kernels` launched on every rank."""
    losses = {r["loss"] for r in ranks}
    if len(losses) != 1:
        raise AssertionError(f"{name}: the ranks report different global losses {losses}")
    loss = ranks[0]["loss"]
    rtol = DP_LOSS_RTOL_F32 if f32 else LOSS_RTOL
    if not (math.isfinite(loss) and abs(loss - one["loss"]) <= rtol * abs(one["loss"])):
        raise AssertionError(f"{name}: loss {loss} on {len(ranks)} ranks vs {one['loss']}")
    worst_err, worst_cos = 0.0, 1.0
    for k, g in one["grads"].items():
        got = ranks[0]["grads"][k]
        if f32:
            err = float((got - g).abs().max()) / max(1.0, float(g.abs().max()))
            if err > DP_GRAD_TOL_F32 * 2:  # atol + rtol, both DP_GRAD_TOL_F32
                raise AssertionError(f"{name}: gradient of {k} off by {err:.3g} (scaled)")
            worst_err = max(worst_err, err)
        else:
            c = _cosine(got, g)
            if c < GRAD_COSINE:
                raise AssertionError(f"{name}: gradient cosine of {k} {c:.6f} < {GRAD_COSINE}")
            worst_cos = min(worst_cos, c)
    if len({r["params_sha256"] for r in ranks}) != 1:
        raise AssertionError(f"{name}: the ranks' updated parameters differ")
    stats_tol = DP_STATS_TOL_F32 if f32 else DP_STATS_TOL_BF16
    worst_stat = 0.0
    for k, b in one["buffers"].items():
        for r in ranks:
            if not torch.equal(r["buffers"][k], ranks[0]["buffers"][k]):
                raise AssertionError(f"{name}: rank {r['rank']} holds other statistics {k}")
        err = float((ranks[0]["buffers"][k] - b).abs().max()) / max(1.0, float(b.abs().max()))
        if err > 2 * stats_tol:
            raise AssertionError(f"{name}: statistics {k} off by {err:.3g} from one rank's")
        worst_stat = max(worst_stat, err)
    launches = [{k: r["launches"][k] for k in "ABCDE"} for r in ranks]
    if any(not l[k] for l in launches for k in kernels):
        raise AssertionError(f"{name}: kernels {kernels} must launch on every rank: {launches}")
    say(f"  {name}: loss {loss:.6f} on {len(ranks)} ranks, {one['loss']:.6f} on one (rel "
        f"{abs(loss - one['loss']) / abs(one['loss']):.3g}); "
        + (f"largest scaled gradient error {worst_err:.3g}" if f32 else
           f"lowest gradient cosine {worst_cos:.6f}")
        + f"; parameters and statistics equal on every rank, the statistics {worst_stat:.3g} "
        f"from one rank's; launches per "
        f"rank A/B/C {[[l[k] for k in 'ABC'] for l in launches]}")
    return dict(loss=loss, loss_one=one["loss"], worst_scaled_grad_err=worst_err,
                worst_cosine=worst_cos, worst_stat_err=worst_stat,
                rank_launches=launches, devices=[r["device"] for r in ranks])


def _timing(res) -> dict:
    t = res["timed"]
    total = sum(t["split_s"].values())
    return dict(median_s_per_step=t["median_s_per_step"],
                allreduce_share=t["split_s"].get("allreduce", 0.0) / total,
                shares={k: v / total for k, v in t["split_s"].items()},
                peak_memory_gb=t["peak_memory_gb"])


def nccl_probe(workdir) -> dict:
    """A one-rank NCCL group on the one card: one all-reduce."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"file://{os.path.join(workdir, 'nccl1')}",
                            rank=0, world_size=1)
    try:
        x = torch.arange(4, dtype=torch.float32, device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        if x.tolist() != [0.0, 1.0, 2.0, 3.0]:
            raise AssertionError(f"one-rank NCCL all-reduce gave {x.tolist()}")
        return {"backend": dist.get_backend(), "world": dist.get_world_size()}
    finally:
        dist.destroy_process_group()


def dp_training_phase(workdir) -> dict:
    """12a (see the module docstring)."""
    from scp_tpu_torch.config import load_config
    from scp_tpu_torch.tools import dryrun_multichip as dry
    from scp_tpu_torch.tools.train_bench_ckpt import gen_shards, recipe_config
    from scp_tpu_torch.train import distributed
    from scp_tpu_torch.train.data import ShardDataset
    from scp_tpu_torch.train.trainer import Trainer

    world, backend = dp_world()
    t0 = time.time()
    out = {"world": world, "backend": backend}
    if backend == "gloo":
        out["nccl_one_rank"] = nccl_probe(workdir)
    shard_dir = os.path.join(workdir, "shards")
    gen_shards(shard_dir, 2, N_POINTS, LIDAR_LEVEL, seed_base=1000)
    root = os.path.join(shard_dir, "*.npy")
    cfg = recipe_config(shard_dir, 8, 8192, config_dir=os.path.join(HERE, "configs"))
    cfg.train.load_pretrain = CKPT
    trainer = Trainer(cfg, 1, device="cuda", static_knn=True)
    trainer.init_state()  # warm from the sknn npz
    state = os.path.join(workdir, "ehem.pt")
    torch.save(trainer.model.state_dict(), state)
    del trainer
    gen = ShardDataset(root, 8192, 8, mode="ehem", seed=42).batches()
    batches = [next(gen) for _ in range(1 + DP_TIMED_STEPS)]
    plain = cfg.to_plain()
    plain["train"]["load_pretrain"] = ""  # the state file carries the warm weights
    ehem = dict(state=state, device="cuda", switches={"static_knn": True})
    spec_bf16 = dict(ehem, cfg=plain, batches=batches)
    spec_f32 = dict(ehem, cfg={**plain, "bf16": False}, batches=batches[:1])
    ocfg = load_config("train_kitti.yaml", os.path.join(HERE, "configs"),
                       ["train.dropout=0.1", "bf16=False", f"data.root={root}"])
    otrainer = Trainer(ocfg, 1, device="cuda")
    otrainer.init_state()
    ostate = os.path.join(workdir, "octattn.pt")
    torch.save(otrainer.model.state_dict(), ostate)
    del otrainer
    obatch = next(ShardDataset(root, 1024, 16, mode="octattn", seed=42).batches())
    spec_oct = dict(cfg=ocfg.to_plain(), state=ostate, device="cuda", switches={},
                    batches=[obatch])
    torch.cuda.empty_cache()
    say(f"  12a setup: {time.time() - t0:.2f} s, {world} ranks over {backend}")

    t0 = time.time()
    ones = [dry.step_worker(s) for s in (spec_f32, spec_bf16, spec_oct)]
    torch.cuda.empty_cache()
    out["one_rank_s"] = time.time() - t0
    t0 = time.time()
    ranks = distributed.run_workers(dry.steps_worker, world,
                                    args=([spec_f32, spec_bf16, spec_oct],), backend=backend,
                                    workdir=os.path.join(workdir, "rdzv"),
                                    threads=max(1, (os.cpu_count() or 1) // world),
                                    timeout_s=DP_JOIN_S)
    out["world_s"] = time.time() - t0
    names = ("ehem_f32", "ehem_bf16", "octattn_f32_dropout0.1")
    for i, name in enumerate(names):
        out[name] = dp_compare(f"12a {name}", ones[i], [r[i] for r in ranks],
                               f32="f32" in name, kernels="" if "octattn" in name else "ABC")
    out["one_rank"] = _timing(ones[1])
    out["per_rank"] = [_timing(r[1]) for r in ranks]
    say(f"  12a bf16 (8, 8192): {out['one_rank']['median_s_per_step']:.4f} s/step on one rank, "
        + ", ".join(f"rank {i} {t['median_s_per_step']:.4f} s/step (all-reduce share "
                    f"{t['allreduce_share']:.3f}, peak {t['peak_memory_gb']:.2f} GB)"
                    for i, t in enumerate(out["per_rank"]))
        + f"; one rank peak {out['one_rank']['peak_memory_gb']:.2f} GB; walls: one rank "
        f"{out['one_rank_s']:.1f} s, the world {out['world_s']:.1f} s (spawn included)")
    return out


def profiled_roundtrip(codec, slices) -> dict:
    """One warm encode + decode under torch.profiler (device activity
    only, to keep its cost down): the wall and each card's kernel
    milliseconds (the host's issue against the devices)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stream, _, _ = codec.encode_to_stream(slices)
        dec = codec.new_stream_decoder(stream, len(slices.occ_stream),
                                       coding_params=codec.coding_params())
        codec.decode(dec, slices.max_level, np.array(slices.pos_mm, np.int64), angular=True,
                     level_sizes=slices.level_sizes)
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    busy: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy[e.device_index] = busy.get(e.device_index, 0.0) + e.time_range.elapsed_us() / 1e3
    return dict(wall_ms=wall_ms, kernel_ms_by_card={f"cuda:{k}": v for k, v in sorted(busy.items())},
                idle_share_by_card={f"cuda:{k}": 1.0 - v / wall_ms for k, v in sorted(busy.items())})


def sharded_codec_phase(model, counted, slices, p4) -> dict:
    """12b (see the module docstring)."""
    import contextlib

    from scp_tpu_torch.codec.ehem_codec import EHEMCodec

    n = torch.cuda.device_count()
    devs = [f"cuda:{i}" for i in range(n)] if n > 1 else ["cuda:0", "cuda:0"]
    codec = EHEMCodec(model, context_size=8192, devices=devs)
    stamp = codec.coding_params()
    if f"devices={len(devs)};" not in stamp:
        raise AssertionError(f"12b: the stamp does not name the device count: {stamp}")
    with contextlib.ExitStack() as stack:
        pcs = [stack.enter_context(PhaseCalls(rep, counted)) for rep in codec.replicas]
        cold = roundtrip(codec, slices, counted.values())
        shards = []
        for i, pc in enumerate(pcs):
            calls = pc.check(f"phase 12b shard {i} ({devs[i]})")
            shards.append(dict(device=devs[i], phase_calls=calls,
                               launches={k: sum(c[2][k] for c in pc.calls) for k in "ABC"}))
    warm = roundtrip(codec, slices, counted.values())
    if abs(cold["bpp"] - p4["bpp"]) > BPP_RTOL * p4["bpp"]:
        raise AssertionError(f"12b bpp {cold['bpp']} is not within {BPP_RTOL} of phase 4's")
    if codec.last_devices != tuple(str(torch.device(d)) for d in devs):
        raise AssertionError(f"12b: the last sharded call ran on {codec.last_devices}")
    stream, _, _ = codec.encode_to_stream(slices)
    try:
        EHEMCodec(model, context_size=8192).new_stream_decoder(
            stream, len(slices.occ_stream), coding_params=stamp)
    except ValueError:
        pass
    else:
        raise AssertionError("12b: a one-device decoder took the sharded stream")
    one = EHEMCodec(model, context_size=8192)
    p4_warm = roundtrip(one, slices, counted.values())
    prof_one = profiled_roundtrip(one, slices)
    prof_sharded = profiled_roundtrip(codec, slices)
    say(f"  12b {len(devs)} shards {devs}: lossless, bpp={cold['bpp']:.4f} (phase 4 "
        f"{p4['bpp']:.4f}), bytes={cold['bytes']}; cold encode {cold['encode_s']:.3f} s, decode "
        f"{cold['decode_s']:.3f} s (phase 4 {p4['encode_s']:.3f} / {p4['decode_s']:.3f}); warm "
        f"{warm['encode_s']:.3f} / {warm['decode_s']:.3f} s (one device warm "
        f"{p4_warm['encode_s']:.3f} / {p4_warm['decode_s']:.3f}); per shard "
        + ", ".join(f"{s['device']} {s['phase_calls']} A/B/C {[s['launches'][k] for k in 'ABC']}"
                    for s in shards))
    say(f"  12b profiled warm roundtrip: one device {prof_one['wall_ms']:.1f} ms wall, kernels "
        f"{prof_one['kernel_ms_by_card']}; sharded {prof_sharded['wall_ms']:.1f} ms wall, kernels "
        f"{prof_sharded['kernel_ms_by_card']}; a decoder of another device count refused the stream")
    return dict(devices=devs, stamp=stamp, bpp=cold["bpp"], bytes=cold["bytes"],
                cold=dict(encode_s=cold["encode_s"], decode_s=cold["decode_s"]),
                warm=dict(encode_s=warm["encode_s"], decode_s=warm["decode_s"]),
                one_device_warm=dict(encode_s=p4_warm["encode_s"], decode_s=p4_warm["decode_s"]),
                shards=shards, launches=cold["launches"], profile_one=prof_one,
                profile_sharded=prof_sharded)


def pipeline_phase(model, slices) -> dict:
    """12c (see the module docstring)."""
    from scp_tpu_torch.codec.ehem_codec import EHEMCodec
    from scp_tpu_torch.codec.slices import split_levels
    from scp_tpu_torch.core.preprocess import kitti_qs, preprocess_points
    from scp_tpu_torch.tools.bench import pipeline_bench

    clouds = [slices] + [
        split_levels(preprocess_points(synth_kitti(np.random.default_rng(s), N_POINTS),
                                       system="spher", qs=kitti_qs(LIDAR_LEVEL)).context,
                     angular=True) for s in (1, 2)]
    codec = EHEMCodec(model, context_size=8192)
    serial, serial_s = [], 0.0
    for sl in clouds:
        r = roundtrip(codec, sl, [])
        serial_s += r["encode_s"] + r["decode_s"]
        serial.append(codec.encode_to_stream(sl)[0])
    pipeline_bench(codec, clouds)  # warm
    wall, streams, _ = pipeline_bench(codec, clouds)
    if streams != serial:
        raise AssertionError("12c: a pipelined payload differs from its serial encode")
    say(f"  12c: 3 sweeps (seeds 0-2) in flight: {wall:.3f} s, lossless, payloads equal to the "
        f"serial encodes; three serial roundtrips {serial_s:.3f} s (x{serial_s / wall:.3f})")
    return dict(clouds=3, wall_s=wall, serial_s=serial_s,
                points_per_sec=3 * N_POINTS / wall, nodes=[len(c.occ_stream) for c in clouds])


def multi_device_phase(model, counted, slices, p4) -> dict:
    """Phase 12 (see the module docstring); returns its numbers."""
    import io
    import shutil
    import tempfile
    from contextlib import redirect_stdout

    from scp_tpu_torch.tools.dryrun_multichip import dryrun_multichip

    work = tempfile.mkdtemp(prefix="scp_phase12_")
    try:
        out = {}
        t0 = time.time()
        out["12a"] = dp_training_phase(work)
        say(f"  12a: {time.time() - t0:.2f} s")
        t0 = time.time()
        out["12b"] = sharded_codec_phase(model, counted, slices, p4)
        say(f"  12b: {time.time() - t0:.2f} s")
        t0 = time.time()
        out["12c"] = pipeline_phase(model, slices)
        say(f"  12c: {time.time() - t0:.2f} s")
        t0 = time.time()
        n = max(2, torch.cuda.device_count())
        buf = io.StringIO()
        with redirect_stdout(buf):
            out["12d"] = dryrun_multichip(n, "cuda", workdir=os.path.join(work, "dry"),
                                          timeout_s=DP_JOIN_S)
        lines = buf.getvalue().strip().splitlines()
        if len(lines) != 2 or not all(line.startswith(f"dryrun_multichip({n}): ")
                                      for line in lines):
            raise AssertionError(f"12d printed {lines}")
        for line in lines:
            say(f"  12d {line}")
        say(f"  12d: {time.time() - t0:.2f} s")
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase12(model, counted, slices, p4) -> dict:
    t0 = time.time()
    p12 = multi_device_phase(model, counted, slices, p4)
    say(f"phase 12 data-parallel training and multi-device coding: {time.time() - t0:.2f} s")
    say(json.dumps({"multi_device": p12}))
    return p12


# ---- phase 13: the last tools (the checkpoint importer, profile_codec, precompile)

# The inverse of scp_tpu_torch/tools/import_torch_ckpt.py's rules: a flat
# flax-layout tree ("params/...", "batch_stats/..." keys, as a weight .npz
# holds them) as the reference SCP state_dict the importer reads.  Test
# scaffolding for phase 13a and tests/test_torch_import_ckpt.py, not a
# feature of the port.
_INV_W = {"kernel": "weight", "bias": "bias"}
_INV_LN = {"scale": "weight", "bias": "bias"}
_INV_SWIN = r"params/swin_(self|cross)/stage_(\d+)/"
_INV_BLOCK = _INV_SWIN + r"block_(\d+)/"


def _inv_block(m) -> str:
    return f"swin_{m[1]}_transformer.layers.{m[2]}.blocks.{m[3]}."


def _inv_linear(path, v):
    """kernel (in, out) -> torch Linear weight (out, in); a bias passes."""
    return v.T if path.endswith("kernel") else v


_INV_EHEM = [
    (r"params/geo/conv(\d)/conv/kernel",
     lambda m: f"geo_feat_generator.conv{m[1]}.0.weight", lambda p, v: v.T[:, :, None, None]),
    (r"params/geo/conv(\d)/bn/(scale|bias)",
     lambda m: f"geo_feat_generator.conv{m[1]}.1.{_INV_LN[m[2]]}", None),
    (r"batch_stats/geo/conv(\d)/bn/(mean|var)",
     lambda m: f"geo_feat_generator.conv{m[1]}.1.running_{m[2]}", None),
    (r"params/geo/(occ|level|octant)_enc/embedding",
     lambda m: f"geo_feat_generator.{m[1]}_enc.weight", None),
    (r"params/geo/(mlp2|mlp3|edge_mlp1|edge_mlp2)/dense_(\d)/(kernel|bias)",
     lambda m: f"geo_feat_generator.{m[1]}.{2 * int(m[2])}.{_INV_W[m[3]]}", _inv_linear),
    (r"params/(ancient_mlp|prob_pred_mlp1|prob_pred_mlp2|pre_occ_mlp|pre_attn_mlp)"
     r"/dense_(\d)/(kernel|bias)",
     lambda m: f"{m[1]}.{2 * int(m[2])}.{_INV_W[m[3]]}", _inv_linear),
    (_INV_BLOCK + r"norm([12])/(scale|bias)",
     lambda m: f"{_inv_block(m)}layernorm_{'before' if m[4] == '1' else 'after'}."
               f"{_INV_LN[m[5]]}", None),
    (_INV_BLOCK + r"attn/(query|key|value)/(kernel|bias)",
     lambda m: f"{_inv_block(m)}attention.self.{m[4]}.{_INV_W[m[5]]}", _inv_linear),
    (_INV_BLOCK + r"attn/rel_pos_bias",
     lambda m: f"{_inv_block(m)}attention.self.relative_position_bias_table", None),
    (_INV_BLOCK + r"attn/proj/(kernel|bias)",
     lambda m: f"{_inv_block(m)}attention.output.dense.{_INV_W[m[4]]}", _inv_linear),
    (_INV_BLOCK + r"mlp1/(kernel|bias)",
     lambda m: f"{_inv_block(m)}intermediate.dense.{_INV_W[m[4]]}", _inv_linear),
    (_INV_BLOCK + r"mlp2/(kernel|bias)",
     lambda m: f"{_inv_block(m)}output.dense.{_INV_W[m[4]]}", _inv_linear),
    (_INV_SWIN + r"merge/reduce/kernel",
     lambda m: f"swin_{m[1]}_transformer.layers.{m[2]}.downsample.reduction.weight",
     lambda p, v: v.T),
    (_INV_SWIN + r"merge/norm/(scale|bias)",
     lambda m: f"swin_{m[1]}_transformer.layers.{m[2]}.downsample.norm.{_INV_LN[m[3]]}", None),
]

_INV_OCTATTN = [
    (r"params/layer_(\d+)/attn/(query|key|value)/(kernel|bias)",
     lambda m: f"transformer_encoder.layers.{m[1]}.attn.mlp_{m[2]}.{_INV_W[m[3]]}", _inv_linear),
    (r"params/layer_(\d+)/ffn([12])/(kernel|bias)",
     lambda m: f"transformer_encoder.layers.{m[1]}.linear{m[2]}.{_INV_W[m[3]]}", _inv_linear),
    (r"params/layer_(\d+)/norm([12])/(scale|bias)",
     lambda m: f"transformer_encoder.layers.{m[1]}.norm{m[2]}.{_INV_LN[m[3]]}", None),
    (r"params/(occ|level|octant)_enc/embedding", lambda m: f"{m[1]}_enc.weight", None),
    (r"params/(abs_pos_enc|decoder0|decoder1)/(kernel|bias)",
     lambda m: f"{m[1]}.{_INV_W[m[2]]}", _inv_linear),
]


def _split_fused(flat: dict) -> dict:
    """Fused Swin projections back to the reference's separate query /
    key / value: self q|k|v, cross k|v (cross keeps its query)."""
    out = {}
    for path, v in flat.items():
        m = re.fullmatch(r"(.*/attn)/(qkv|kv)/(kernel|bias)", path)
        if not m:
            out[path] = v
            continue
        names = ("query", "key", "value") if m[2] == "qkv" else ("key", "value")
        for name, part in zip(names, np.split(v, len(names), axis=-1)):
            out[f"{m[1]}/{name}/{m[3]}"] = part
    return out


def reference_state_dict(flat: dict, model: str = "ehem") -> dict:
    """A flat flax-layout tree -> the reference state_dict (CPU f32 tensors),
    with the buffers the importer skips (BatchNorm `num_batches_tracked`,
    Swin `relative_position_index`, OctAttention's causal `mask`)."""
    rules = {"ehem": _INV_EHEM, "octattention": _INV_OCTATTN}[model]
    sd = {}
    for path, v in _split_fused(flat).items():
        v = np.asarray(v, np.float32)
        for pat, key, xf in rules:
            m = re.fullmatch(pat, path)
            if m:
                break
        else:
            raise KeyError(f"no reference key for {path}")
        name = key(m)
        sd[name] = torch.from_numpy(np.ascontiguousarray(v if xf is None else xf(path, v)))
        if name.endswith("running_mean"):
            sd[name.replace("running_mean", "num_batches_tracked")] = torch.tensor(0)
        if name.endswith("relative_position_bias_table"):
            w = (v.shape[0] + 1) // 2
            ar = torch.arange(w)
            sd[name.replace("bias_table", "index")] = ar[:, None] - ar[None, :] + w - 1
    if model == "octattention":
        sd["mask"] = torch.ones(1024, 1024, dtype=torch.bool).triu(1)
    return sd


def _flat_npz(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _same_bits(got: dict, want: dict) -> list:
    """Keys whose f32 arrays differ from `want`'s (f16 widened exactly),
    bit for bit; a key on one side only counts too."""
    bad = sorted(set(got) ^ set(want))
    for k in set(got) & set(want):
        a, b = np.asarray(got[k], np.float32), np.asarray(want[k], np.float32)
        if a.shape != b.shape or not np.array_equal(a.view(np.uint32), b.view(np.uint32)):
            bad.append(k)
    return bad


def import_ckpt(flat: dict, model: str, workdir: str, name: str) -> dict:
    """Write `flat` as a Lightning-style reference checkpoint, import it with
    the CLI in a fresh process (no --trust_pickle), check the written npz
    against `flat` bit for bit and return its path; the import's wall is
    printed."""
    ckpt, out = os.path.join(workdir, f"{name}.ckpt"), os.path.join(workdir, f"{name}.npz")
    torch.save({"state_dict": reference_state_dict(flat, model), "epoch": 0,
                "global_step": 0}, ckpt)
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "scp_tpu_torch.tools.import_torch_ckpt",
                           "--ckpt", ckpt, "--model", model, "--out", out], cwd=HERE,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"13a: import_torch_ckpt --model {model} failed (rc "
                             f"{proc.returncode}):\n{proc.stderr[-3000:]}")
    got = _flat_npz(out)
    bad = _same_bits(got, flat)
    if bad:
        raise AssertionError(f"13a {model}: imported arrays differ from the source: {bad[:5]}")
    say(f"  13a {model}: {proc.stdout.strip()} in {time.time() - t0:.2f} s "
        f"({os.path.getsize(ckpt) / 1e6:.1f} MB checkpoint); every array equals "
        f"{name}'s source bit for bit")
    return out


def import_phase(counted, slices, p4, workdir) -> dict:
    """13a (see the module docstring)."""
    from scp_tpu_torch.codec.ehem_codec import EHEMCodec
    from scp_tpu_torch.codec.octattn_codec import OctAttentionCodec
    from scp_tpu_torch.core.preprocess import kitti_qs, preprocess_points
    from scp_tpu_torch.models.ehem import EHEM
    from scp_tpu_torch.models.octattention import OctAttention
    from scp_tpu_torch.weights import load_into

    imported = import_ckpt(_flat_npz(CKPT), "ehem", workdir, "ref_ehem")  # the npz's path
    model = load_into(EHEM(static_knn=True, dtype=torch.bfloat16, device="cuda"), imported)
    with PhaseCalls(model, counted) as pc:
        r = roundtrip(EHEMCodec(model, context_size=8192), slices, counted.values())
        calls = pc.check("phase 13a")
    if r["sha256"] != p4["sha256"] or r["bytes"] != p4["bytes"]:
        raise AssertionError(f"13a: the imported model's payload ({r['bytes']} bytes) differs "
                             f"from phase 4's ({p4['bytes']} bytes)")
    say(f"  13a ehem: the imported full-width model's L16 roundtrip is lossless, payload "
        f"byte-identical to phase 4's ({r['bytes']} bytes, bpp={r['bpp']:.4f}); phase calls "
        f"{calls}, launches A/B/C/D/E {r['launches']}")
    del model

    got = import_ckpt(_flat_npz(OCT_CKPT), "octattention", workdir, "ref_octattn")
    pts = synth_kitti(np.random.default_rng(0), N_POINTS).astype(np.float32)
    ctx = preprocess_points(pts, system="spher", qs=kitti_qs(OCT_LEVEL)).context
    ref = load_into(OctAttention(device="cuda"), OCT_CKPT)
    levels, _, _ = OctAttentionCodec(ref).split_levels(ctx)
    data, pos = levels[int(np.argmax([d.shape[0] for d, _ in levels]))]
    d = torch.from_numpy(data[None, :1024].astype(np.int32)).cuda()
    p = torch.from_numpy(pos[None, :1024]).cuda()
    with torch.no_grad():
        want = ref(d, p)
        logits = load_into(OctAttention(device="cuda"), got)(d, p)
    if not torch.equal(logits, want):
        raise AssertionError("13a: the imported OctAttention's logits differ from the npz's")
    say(f"  13a octattention: a 1024-row window's logits {tuple(logits.shape)} bit-identical "
        "to the npz-loaded model's")
    return dict(ehem_bytes=r["bytes"], ehem_bpp=r["bpp"], phase_calls=calls,
                launches=dict(zip("ABCDE", r["launches"])),
                encode_s=r["encode_s"], decode_s=r["decode_s"])


def profile_phase(smi: str) -> dict:
    """13b (see the module docstring)."""
    from scp_tpu_torch.tools import profile_codec

    out = {}
    for argv in (["--what", "codec", "--group", "8", "--mode", "rans"],
                 ["--what", "codec", "--group", "8", "--mode", "staged"],
                 ["--what", "codec", "--group", "8", "--mode", "full"],
                 ["--what", "train", "--batch", "8"],
                 ["--what", "train", "--batch", "8", "--remat"]):
        r = profile_codec.main(argv)
        tag = (("train_remat" if r["remat"] else "train") if r["what"].startswith("train")
               else f"codec_{r['mode']}")
        times = ([r["step_s"]] if tag.startswith("train") else
                 [r["phase1_s"], r["phase2_s"], r["fetch_hi_cdf_s"], r["fetch_iv_s"],
                  r["ac_enc_s_per_mnode"], r["ac_dec_s_per_mnode"]])
        if not all(math.isfinite(t) and t >= 0 for t in times) or min(times[:2]) <= 0:
            raise AssertionError(f"13b {tag}: a time is not finite and positive: {times}")
        if tag in ("codec_staged", "codec_full") and r["fetch_hi_cdf_s"] <= 0:
            raise AssertionError(f"13b {tag}: no fetch time")
        mfus = [v for k, v in r.items() if k.endswith("mfu_pct")]
        if not mfus or not all(v is not None and 0 < v <= 100 for v in mfus):
            raise AssertionError(f"13b {tag}: MFU outside (0, 100]: {mfus}")
        if any(r["launches"][k] == 0 for k in "ABC"):
            raise AssertionError(f"13b {tag}: A, B or C never launched in the timed calls: "
                                 f"{r['launches']}")
        out[tag] = r
        torch.cuda.empty_cache()
    c = out["codec_rans"]
    say(f"  13b on {smi}: phase 1 at (8, 8192) {c['phase1_s'] * 1e3:.3f} ms, "
        f"{c['phase1_flops'] / 1e12:.4f} TFLOP, MFU {c['phase1_mfu_pct']:.3f}%; phase 2 "
        f"{c['phase2_s'] * 1e3:.3f} ms, MFU {c['phase2_mfu_pct']:.3f}%; staged / full phase 1 "
        f"{out['codec_staged']['phase1_s'] * 1e3:.3f} / {out['codec_full']['phase1_s'] * 1e3:.3f}"
        f" ms; train step {out['train']['step_s']:.4f} s, MFU {out['train']['mfu_pct']:.3f}%, "
        f"{out['train']['tokens_per_s']:.1f} tokens/s; with remat "
        f"{out['train_remat']['step_s']:.4f} s, MFU {out['train_remat']['mfu_pct']:.3f}%")
    return out


def precompile_phase(model, slices) -> dict:
    """13c (see the module docstring)."""
    from scp_tpu_torch.codec.ehem_codec import EHEMCodec
    from scp_tpu_torch.ops import _cuda

    plans, _, _ = EHEMCodec(model, context_size=8192)._plan_levels(slices.level_sizes)
    shapes = len({(la, w) for calls, _ in plans for _, la, w in calls})
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "scp_tpu_torch.tools.precompile", "--points",
                           str(N_POINTS), "--levels", str(LIDAR_LEVEL)], cwd=HERE,
                          capture_output=True, text=True, timeout=600)
    wall = time.time() - t0
    if proc.returncode != 0:
        raise AssertionError(f"13c: precompile failed (rc {proc.returncode}):\n"
                             f"{proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    r = json.loads(lines[-1])
    libs, cls = r["libraries"], r["classes"][0]
    if (libs["kernels"]["cold"] or set(libs["kernels"]["cached"]) != set(_cuda.SOURCES)
            or libs["native"] != "cached"):
        raise AssertionError(f"13c: a library was not reused: {libs}")
    if cls["phase_shapes"] != shapes:
        raise AssertionError(f"13c: {cls['phase_shapes']} phase shapes, phase 4's plan {shapes}")
    for line in lines[:-1]:
        say(f"  13c {line}")
    say(f"  13c: every library reused; {shapes} phase shapes (phase 4's plan); seed "
        f"{cls['seed_s']:.3f} s, re-warm {cls['rewarm_s']:.3f} s; the process {wall:.2f} s")
    return dict(phase_shapes=shapes, seed_s=cls["seed_s"], rewarm_s=cls["rewarm_s"],
                process_s=wall, libraries=libs)


def phase13(model, counted, slices, p4, smi) -> dict:
    import shutil

    t0 = time.time()
    work = os.path.join(HERE, "chiprun_out", "phase13")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        out = {}
        t = time.time()
        out["13a"] = import_phase(counted, slices, p4, work)
        say(f"  13a: {time.time() - t:.2f} s")
    finally:  # the checkpoints (~100 MB each) do not come back
        shutil.rmtree(work, ignore_errors=True)
    t = time.time()
    out["13b"] = profile_phase(smi)
    say(f"  13b: {time.time() - t:.2f} s")
    t = time.time()
    out["13c"] = precompile_phase(model, slices)
    say(f"  13c: {time.time() - t:.2f} s")
    say(f"phase 13 the last tools (importer, profile_codec, precompile): "
        f"{time.time() - t0:.2f} s")
    say(json.dumps({"tools": out}))
    return out


# ---- phase 14: the dynamic-graph EHEM -----------------------------------------

# the root bench.py's TPU record of the dynamic graph with this checkpoint
# (bench.py:176-179, approximate top-k there); printed beside 14a, not a gate
TPU_DYNAMIC_BPP = 18.175


def load_dynamic(**switches):
    """The full-width bf16 EHEM on the dynamic graph (static KNN off) from
    its own checkpoint, ehem_synth_f16.npz."""
    from scp_tpu_torch.models.ehem import EHEM
    from scp_tpu_torch.weights import load_into

    return load_into(EHEM(static_knn=False, dtype=torch.bfloat16, device="cuda", **switches),
                     DYN_CKPT)


def dynamic_features(model, slices, lanes: int, width: int):
    """The dynamic model's own EdgeConv 2 and 3 inputs (C = 144, 192) in
    the largest level's (lanes, width) phase-1 call: that level's contexts
    (pad rows: level 0, octant 0, occupancy 255) and level_positions."""
    li = int(np.argmax(slices.level_sizes))
    n = min(len(slices.data[li]), lanes * width)
    d = np.zeros((lanes * width, 4, 3), np.int64)
    d[..., 2] = 255
    d[:n] = slices.data[li][:n]
    data = torch.from_numpy(d).to("cuda", torch.int32).reshape(lanes, width, 4, 3)
    got = {}
    inner = model.geo._knn

    def record(feats, k):
        got[feats.shape[-1]] = feats.detach().contiguous()
        return inner(feats, k)

    model.geo._knn = record
    try:
        with torch.no_grad():
            model.decode_phase1(data, level_positions(slices, lanes, width).float())
    finally:
        del model.geo._knn
    return got[144], got[192]


def timed_knn_seam(model, times):
    """Wraps the DGCNN's KNN seam of `model` with CUDA events: appends
    (C, start, stop) for every graph it builds.  Returns the undo."""
    inner = model.geo._knn

    def timed(feats, k):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        idx = inner(feats, k)
        stop.record()
        times.append((feats.shape[-1], start, stop))
        return idx

    model.geo._knn = timed
    return lambda: delattr(model.geo, "_knn")


def dynamic_roundtrip(tag, model, slices, counted):
    """One roundtrip of the dynamic model with its phase-1 calls of N >=
    2048 rows counted and its KNN seam timed (ms by graph width)."""
    from scp_tpu_torch.codec.ehem_codec import EHEMCodec
    from scp_tpu_torch.ops import knn
    from scp_tpu_torch.ops import knn_topk

    codec = EHEMCodec(model, context_size=8192)
    calls, times = [], []
    inner_p1 = model.decode_phase1

    def p1(data, pos):
        calls.append(tuple(data.shape[:2]))
        return inner_p1(data, pos)

    model.decode_phase1 = p1
    undo = timed_knn_seam(model, times)
    try:
        r = roundtrip(codec, slices, counted)
    finally:
        undo()
        del model.decode_phase1
    torch.cuda.synchronize()
    ms = {}
    for c, start, stop in times:
        ms[c] = ms.get(c, 0.0) + start.elapsed_time(stop)
    r.update(stamp=codec.coding_params(), arms=dict(knn_topk.knn_topk.arms),
             big_calls=sum(1 for _, w in calls if w >= knn.FUSED_MIN_N), phase1_calls=len(calls),
             knn_ms={str(c): v for c, v in sorted(ms.items())},
             knn_wide_ms=sum(v for c, v in ms.items() if c > knn_topk.PRUNED_MAX_C))
    say(f"  14{tag}: lossless, bpp={r['bpp']:.4f}, bytes={r['bytes']}, encode "
        f"{r['encode_s']:.3f} s, decode {r['decode_s']:.3f} s; KNN seam ms by width "
        f"{r['knn_ms']} (feature graphs {r['knn_wide_ms']:.1f} ms); launches A/B/C/D/E "
        f"{r['launches']}, D arms {r['arms']}; {r['big_calls']} of {r['phase1_calls']} "
        f"phase-1 calls with N >= {knn.FUSED_MIN_N}")
    return r


def dynamic_phase(counted, slices) -> dict:
    """Phase 14: JAX's default DGCNN (the dynamic graph) at full width from
    ehem_synth_f16.npz on the L16 cloud: 14a the switches off, 14b
    pallas_knn (kernel D on all three graphs of the calls of N >= 2048
    rows: the pruned arm on the positions, the wide arm on C = 144 and
    192), 14c pallas_knn with D alone on its plain version (the DGCNN's own
    plain_seams), every roundtrip lossless."""
    from scp_tpu_torch.codec.ehem_codec import KNN_WIDE_NUMERICS

    t0 = time.time()
    out = {}
    ia, ib = list(counted).index("D"), list(counted).index("A")
    model = load_dynamic()
    out["a"] = dynamic_roundtrip("a", model, slices, counted.values())
    if out["a"]["launches"][ia]:
        raise AssertionError("14a: kernel D launched with pallas_knn off")
    say(f"  14a bpp {out['a']['bpp']:.4f} beside the TPU record {TPU_DYNAMIC_BPP} "
        f"(approximate top-k there)")
    del model
    model = load_dynamic(pallas_knn=True)
    out["b"] = dynamic_roundtrip("b", model, slices, counted.values())
    arms, big = out["b"]["arms"], out["b"]["big_calls"]
    if not big or arms["wide"] != 2 * big or arms["pruned"] != big:
        raise AssertionError(f"14b: D arms {arms} for {big} phase-1 calls of N >= 2048 "
                             f"(one pruned and two wide launches each)")
    if out["b"]["launches"][ib] == 0:
        raise AssertionError("14b: kernel A never launched")
    say(f"  stamps: 14a {out['a']['stamp']}; 14b {out['b']['stamp']}")
    if "knnwide=" in out["a"]["stamp"] or f"knnwide={KNN_WIDE_NUMERICS}" not in out["b"]["stamp"]:
        raise AssertionError("14: the stamp does not name the wide arm where it runs")
    model.geo.plain_seams = True  # D's plain version on the card; A, B, C stay kernels
    out["c"] = dynamic_roundtrip("c", model, slices, counted.values())
    if out["c"]["launches"][ia]:
        raise AssertionError("14c: kernel D launched under the DGCNN's plain_seams")
    if abs(out["b"]["bpp"] - out["c"]["bpp"]) > BPP_RTOL * out["c"]["bpp"]:
        raise AssertionError(f"14b bpp {out['b']['bpp']} is not within {BPP_RTOL} of 14c's "
                             f"{out['c']['bpp']}")
    say(f"phase 14 dynamic graph: {time.time() - t0:.2f} s; bpp 14a/14b/14c "
        f"{out['a']['bpp']:.4f} / {out['b']['bpp']:.4f} / {out['c']['bpp']:.4f} (14b vs 14c "
        f"{abs(out['b']['bpp'] / out['c']['bpp'] - 1):.2e}, gate {BPP_RTOL}; 14a vs 14b "
        f"{out['a']['bpp'] / out['b']['bpp'] - 1:+.2e}, reported)")
    return out


# ---- phase 15: the rANS coder's kernels ----------------------------------------


def rans_launches() -> int:
    from scp_tpu_torch.codec import rans

    return rans.encode_kernel.launches + rans.decode_group_kernel.launches


def rans_resources(cuda):
    """Registers and spills of the coder's two kernels; fails on any spill."""
    rows = {name: r for name in ("rans_decode_group", "rans_encode")
            for r in cuda.ptxas_report("rans.cu", name)}
    if len(rows) != 2:
        raise AssertionError(f"rans kernels in the build log: {sorted(rows)}")
    return check_spills(rows, "rANS")


def rans_group(gen, n: int):
    """One group of n symbols on the card: rows as the codec makes them
    (logits_to_cdf of random logits), symbols drawn from them by the
    decode rule, and their (cdf_low, freq) rows."""
    from scp_tpu_torch.codec import rans
    from scp_tpu_torch.codec.ehem_codec import logits_to_cdf

    n_pad = rans.pad_to_chunk(n)
    rows = torch.zeros((n_pad, 256), dtype=torch.int32, device="cuda")
    syms = torch.zeros(n_pad, dtype=torch.int64, device="cuda")
    for a in range(0, n, rans.CHUNK):  # (CHUNK, 256) int64 at a time
        b = min(a + rans.CHUNK, n)
        rows[a:b] = logits_to_cdf(3.0 * torch.randn(b - a, 255, generator=gen, device="cuda"))
        u = torch.randint(0, 1 << 16, (b - a, 1), generator=gen, device="cuda")
        syms[a:b] = (rans._row_i32(rows[a:b])[:, :255] <= u).sum(-1) - 1
    return rows, syms, rans.gather_start_freq(rows, syms)


def rans_phase(slices, l16_launches: int, resources: dict) -> dict:
    """15 (see the module docstring)."""
    from scp_tpu_torch.codec import rans

    t0 = time.time()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    n_l16 = (slices.level_sizes[-1] + 1) // 2  # the last level's even-parity group
    out = {"l16_roundtrip_launches": l16_launches, "ptxas": resources}
    for tag, n in (("chunk", rans.CHUNK), ("l16_group", n_l16)):
        rows, syms, sf = rans_group(gen, n)
        used = min(n, rans.K_LANES)
        enc = rans.RansEncoder("cuda")
        enc.append_group(sf, n)
        payload = enc.finish()
        head, body = enc._finish_plain(used)
        if payload != np.uint16(used).tobytes() + head + body:
            raise AssertionError(f"phase 15 {tag}: the kernel's stream differs from the plain loops'")
        kern, plain = rans.RansDecoder(payload, "cuda"), rans.RansDecoder(payload, "cuda")
        got, want = kern.decode_group(rows, n), plain._decode_group_plain(rows, n)
        if not (torch.equal(got, want) and torch.equal(got[:n].long(), syms[:n])
                and torch.equal(kern.states, plain.states) and torch.equal(kern.ptr, plain.ptr)):
            raise AssertionError(f"phase 15 {tag}: the kernel's decode differs from the plain loops'")
        reps = 20
        init = rans.RansDecoder(payload, "cuda")
        # each timed decode starts from the stream's first state
        fresh = iter([(init.states.clone(), init.ptr.clone()) for _ in range(reps + 1)])
        dec_ms = cuda_time_ms(
            lambda: rans.decode_group_kernel(*next(fresh), kern.stream, rows, n), reps)

        def plain_decode():
            plain.states, plain.ptr = init.states.clone(), init.ptr.clone()
            return plain._decode_group_plain(rows, n)

        dec_plain_ms = cuda_time_ms(plain_decode, 2)
        enc_ms = cuda_time_ms(lambda: rans.encode_kernel(enc.groups, "cuda"), reps)
        finish_ms = cuda_time_ms(enc.finish, reps)
        enc_plain_ms = cuda_time_ms(lambda: enc._finish_plain(used), 2)
        steps = -(-n // rans.K_LANES)
        # least bytes: decode needs the sector of a row that holds the two
        # entries around the slot, the stream, and writes a byte a symbol;
        # encode reads 16 bytes a symbol and writes the stream.  The serial
        # chain (a dependent row search and a block scan a step) binds both
        # far above these bounds
        dec_bound, dec_by = bound_ms(n * (32 + 1) + len(body), 0)
        enc_bound, enc_by = bound_ms(n * 16 + len(body) + 8 * rans.K_LANES, 0)
        out[tag] = dict(symbols=n, steps=steps, bytes=len(payload),
                        decode_ms=dec_ms, decode_plain_ms=dec_plain_ms,
                        decode_us_per_step=1e3 * dec_ms / steps, decode_bound_ms=dec_bound,
                        encode_ms=enc_ms, finish_ms=finish_ms, encode_plain_ms=enc_plain_ms,
                        encode_us_per_step=1e3 * enc_ms / steps, encode_bound_ms=enc_bound,
                        bound_by=dec_by)
        say(f"  15 {tag}: {n} symbols, {steps} steps; decode kernel {dec_ms:.4f} ms "
            f"({1e3 * dec_ms / steps:.2f} us a step), plain {dec_plain_ms:.2f} ms, bound "
            f"{dec_bound:.4f} ms ({dec_by}); encode kernel {enc_ms:.4f} ms, finish() "
            f"{finish_ms:.4f} ms, plain {enc_plain_ms:.2f} ms, bound {enc_bound:.4f} ms")
        del rows, syms, sf, enc, kern, plain, init, fresh
    say(f"phase 15 rANS kernels: identical to the plain loops; {l16_launches} launches an L16 "
        f"roundtrip; {time.time() - t0:.2f} s")
    return out


def cached_attn_resources(cuda):
    """Registers and spills of the cached attention's two kernels in both
    element types; fails on any spill."""
    rows = {r["kernel"]: r for r in cuda.ptxas_report("cached_attn.cu", "cached_attn_")}
    if len(rows) != 4:
        raise AssertionError(f"cached attention kernels in the build log: {sorted(rows)}")
    return check_spills(rows, "cached attention")


def graph_time_ms(fn, reps: int = 20) -> float:
    """ms a call of fn, from `reps` calls captured in one CUDA graph and
    replayed: the device's time, without the host's launch cost."""
    from scp_tpu_torch.utils.cuda_graphs import capture

    graph, _ = capture(lambda: [fn() for _ in range(reps)])
    return cuda_time_ms(graph.replay, 5) / reps


def cached_attn_phase() -> dict:
    """16 (see the module docstring)."""
    from scp_tpu_torch.ops import cached_attn

    t0 = time.time()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    heads, window, hd, length = 4, 1024, 150, 1023
    out = {"shape": [128, heads, length, hd]}
    for lanes in (128, 32, 8, 1):
        for dtype in (torch.float32, torch.bfloat16):
            def r(*s):
                return torch.randn(*s, generator=gen, device="cuda").to(dtype)

            args = (r(lanes, heads * hd), r(lanes, heads * hd), r(lanes, heads * hd),
                    r(lanes, heads, window, hd), r(lanes, heads, window, hd))
            dev_len = torch.tensor(length, dtype=torch.int64, device="cuda")
            got = cached_attn.cached_attention(*args, dev_len)
            f32 = dtype == torch.float32
            if f32:
                want = cached_attn.cached_attention_plain(*args, length)
                err = check_close(f"cached attention {lanes} lanes f32", got, want, F32_TOL)
            else:
                # the kernel sums in f32, so a bf16 call differs from the f32
                # products of its own operands only by the output's rounding:
                # half a bf16 ulp, <= 2^-8 of the value; twice that, and an
                # atol for the f32 summation order (a dropped self slot,
                # chunk or split moves outputs by percents)
                want = cached_attn.cached_attention_plain(*(a.float() for a in args), length)
                err = check_close(f"cached attention {lanes} lanes bf16", got, want,
                                  ATTN_BF16_ATOL, ATTN_BF16_RTOL)
            es = args[0].element_size()
            # each cached K and V row read once; q, k_self, v_self read, out written
            n_bytes = es * (2 * lanes * heads * length * hd + 4 * lanes * heads * hd)
            flops = 4 * lanes * heads * (length + 1) * hd
            bound, by = bound_ms(n_bytes, flops, PEAK_F32_FLOPS)
            row = dict(max_abs_err=err, bound_ms=bound, bound_by=by, bytes=n_bytes,
                       ms=graph_time_ms(lambda: cached_attn.cached_attention(*args, dev_len)),
                       eager_ms=cuda_time_ms(
                           lambda: cached_attn.cached_attention(*args, dev_len), 20, warm=3),
                       # the plain version, the position a device scalar read back
                       plain_ms=cuda_time_ms(
                           lambda: cached_attn.cached_attention_plain(*args, dev_len), 5),
                       # the step's batched products with a host position: the
                       # port's eager _attend_cached before the kernel
                       library_ms=cuda_time_ms(
                           lambda: cached_attn.cached_attention_plain(*args, length), 5))
            row["bound_share"] = row["bound_ms"] / row["ms"]
            out[f"{lanes}_{'f32' if f32 else 'bf16'}"] = row
            del args, got, want
    m = out["128_f32"]
    say(f"phase 16 cached attention: {time.time() - t0:.2f} s; at (128 lanes, {heads} heads, "
        f"length {length}, hd {hd}) f32: {m['ms']:.4f} ms/launch, bound {m['bound_ms']:.4f} ms "
        f"({m['bound_by']}; {100 * m['bound_share']:.1f}% of it), plain {m['plain_ms']:.4f} ms, "
        f"library (eager batched products) {m['library_ms']:.4f} ms")
    for k, v in out.items():
        if k != "shape":
            say(f"  {k}: {v['ms']:.4f} ms (eager {v['eager_ms']:.4f}), bound "
                f"{v['bound_ms']:.4f} ms ({100 * v['bound_share']:.1f}%), plain "
                f"{v['plain_ms']:.4f}, library {v['library_ms']:.4f}, max_abs_err "
                f"{v['max_abs_err']:.3g}")
    return out


def main(argv=None) -> int:
    """`--phase12-only`: phases 0, 1, 3 and 4 (phase 12's yardstick), then
    phase 12, and no kernel table (a multi-card run of the new phase)."""
    argv = sys.argv[1:] if argv is None else argv
    only12 = "--phase12-only" in argv
    t_start = time.time()
    if not torch.cuda.is_available():
        say("chip_smoke: no CUDA device available; this smoke runs on the card only")
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    say(smi)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    from scp_tpu_torch.codec.ehem_codec import EHEMCodec
    from scp_tpu_torch.codec.slices import split_levels
    from scp_tpu_torch.core.preprocess import kitti_qs, preprocess_points
    from scp_tpu_torch.models.ehem import EHEM
    from scp_tpu_torch.ops import _cuda, cached_attn, knn_topk, window_attn
    from scp_tpu_torch.ops import mlp as mlp_ops
    from scp_tpu_torch.ops import swin_attn
    from scp_tpu_torch.weights import load_into

    # ---- 1. build
    built = _cuda.build_all()
    say(f"phase 1 build: {built['seconds']:.2f} s, cold {built['cold']}, "
        f"cached {built['cached']}")
    resources = {**sm90_resources(_cuda), **knn_resources(_cuda)}
    rans_res = rans_resources(_cuda)
    cattn_res = cached_attn_resources(_cuda)

    # ---- 3 (needed by 2). the model
    t0 = time.time()
    model = EHEM(static_knn=True, dtype=torch.bfloat16, device="cuda")
    load_into(model, CKPT)
    torch.cuda.synchronize()
    say(f"phase 3 model: full-width EHEM from {os.path.basename(CKPT)} "
        f"(static KNN on) in {time.time() - t0:.2f} s")

    # the L16 cloud (phase 2 reads its positions, phases 4 and 5 code it)
    t0 = time.time()
    pts = synth_kitti(np.random.default_rng(0), N_POINTS)
    res = preprocess_points(pts, system="spher", qs=kitti_qs(LIDAR_LEVEL))
    slices = split_levels(res.context, angular=True)
    n_nodes = int(slices.occ_stream.shape[0])
    say(f"preprocess: {time.time() - t0:.2f} s, {n_nodes} nodes, {slices.max_level} levels")

    counted = {"A": mlp_ops.ln_mlp_residual, "B": swin_attn.attn_sublayer_self,
               "C": swin_attn.attn_sublayer_cross, "D": knn_topk.knn_topk,
               "E": window_attn.window_attention}
    if only12:
        p4 = roundtrip(EHEMCodec(model, context_size=8192), slices, counted.values())
        say(f"phase 4 roundtrip: lossless, bpp={p4['bpp']:.4f}, encode {p4['encode_s']:.3f} s, "
            f"decode {p4['decode_s']:.3f} s, kernel launches A/B/C/D/E = {p4['launches']}")
        phase12(model, counted, slices, p4)
        say(f"total wall {time.time() - t_start:.1f} s")
        say(json.dumps({"ok": True, "phases": "0, 1, 3, 4, 12", "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # ---- 2. kernels vs plain
    t0 = time.time()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    dyn_feats = dynamic_features(load_dynamic(), slices, 15, 8192)
    with torch.no_grad():
        rows = kernel_phase(model, gen, slices, dyn_feats)
    del dyn_feats
    say(f"phase 2 kernels vs plain: {time.time() - t0:.2f} s")
    for k, r in rows.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        say(f"  {k} {r['name']}: {r['ms']:.4f} ms/launch at {r.get('shape', r.get('tokens'))}, "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"library {lib}")
    d, e = rows["D"], rows["E"]
    say(f"  D shuffled positions: {d['shuffled_ms']:.4f} ms, bound {d['shuffled_bound_ms']:.4f} ms; "
        f"share of the brute-force work scored: sorted {d['groups_visited_share']:.4f}, "
        f"shuffled {d['groups_visited_shuffled_share']:.4f}")
    say(f"  D main-path KNN (ops/knn.knn_indices) {d['main_path_knn_ms']:.4f} ms; at C=192: "
        f"kernel {d['c192_ms']:.4f}, plain {d['c192_plain_ms']:.4f}, main-path KNN "
        f"{d['c192_main_path_knn_ms']:.4f}, bound {d['c192_bound_ms']:.4f} ms")
    say(f"  E at {e['bn240_shape']}: kernel {e['bn240_ms']:.4f}, plain {e['bn240_plain_ms']:.4f}, "
        f"SDPA {e['bn240_library_ms']:.4f}, bound {e['bn240_bound_ms']:.4f} ms")
    b = rows["B"]
    say(f"  B's attention core at B's layout: kernel {b['core_ms']:.4f}, plain "
        f"{b['core_plain_ms']:.4f}, SDPA {b['core_library_ms']:.4f}, bound "
        f"{b['core_bound_ms']:.4f} ms")
    for k in ("A", "B", "C", "E"):
        r = rows[k]
        say(f"  {k} in f32: {r['f32_ms']:.4f} ms/launch, plain {r['f32_plain_ms']:.4f} ms, "
            f"bound {r['f32_bound_ms']:.4f} ms ({r['f32_bound_by']}), "
            f"max_abs_err {r['f32_max_abs_err']:.3g}")

    # ---- 4. the main path: one encode, one decode
    r0 = rans_launches()
    p4 = roundtrip(EHEMCodec(model, context_size=8192), slices, counted.values())
    p4_rans = rans_launches() - r0
    say(f"phase 4 roundtrip: lossless, bpp={p4['bpp']:.4f}, nodes={n_nodes}, "
        f"bytes={p4['bytes']}, encode {p4['encode_s']:.3f} s, decode {p4['decode_s']:.3f} s, "
        f"kernel launches A/B/C/D/E = {p4['launches']}")
    if p4["launches"][3] or p4["launches"][4]:
        raise AssertionError("kernels D and E launched with their switches off")
    for k in ("A", "B", "C"):  # bf16 at C = 256: every launch on the Hopper kernels
        if counted[k].arms["sm90"] < p4["launches"][list(counted).index(k)]:
            raise AssertionError(f"kernel {k} left the Hopper GEMM arm: {counted[k].arms}")
    say(f"  GEMM arms of phase 4 (A/B/C): {[counted[k].arms for k in 'ABC']}")
    if abs(p4["bpp"] - MAIN_PATH_BPP) > BPP_RTOL * MAIN_PATH_BPP:
        raise AssertionError(f"phase 4 bpp {p4['bpp']} is not within {BPP_RTOL} of "
                             f"{MAIN_PATH_BPP}")

    # ---- 5. the fused-kernel configuration (pallas_knn, pallas_attn)
    t0 = time.time()
    model5 = EHEM(static_knn=True, pallas_knn=True, pallas_attn=True, dtype=torch.bfloat16,
                  device="cuda")
    load_into(model5, CKPT)
    codec5 = EHEMCodec(model5, context_size=8192)
    say(f"phase 5 model: {time.time() - t0:.2f} s, stamp {codec5.coding_params()}")
    p5 = roundtrip(codec5, slices, counted.values())
    say(f"phase 5 roundtrip: lossless, bpp={p5['bpp']:.4f}, bytes={p5['bytes']}, "
        f"encode {p5['encode_s']:.3f} s, decode {p5['decode_s']:.3f} s, "
        f"kernel launches A/B/C/D/E = {p5['launches']}")
    if abs(p5["bpp"] - p4["bpp"]) > BPP_RTOL * p4["bpp"]:
        raise AssertionError(f"phase 5 bpp {p5['bpp']} is not within {BPP_RTOL} of phase 4's")

    # ---- 6. an f32 model with pallas_attn on: A, B, C and E in f32
    t0 = time.time()
    model6 = EHEM(static_knn=True, pallas_attn=True, dtype=torch.float32, device="cuda")
    load_into(model6, CKPT)
    codec6 = EHEMCodec(model6, context_size=8192)
    say(f"phase 6 model: {time.time() - t0:.2f} s, stamp {codec6.coding_params()}")
    p6 = roundtrip(codec6, slices, counted.values())
    say(f"phase 6 roundtrip (f32): lossless, bpp={p6['bpp']:.4f}, bytes={p6['bytes']}, "
        f"encode {p6['encode_s']:.3f} s, decode {p6['decode_s']:.3f} s, "
        f"kernel launches A/B/C/D/E = {p6['launches']}")
    if abs(p6["bpp"] - F32_PLAIN_BPP) > BPP_RTOL * F32_PLAIN_BPP:
        raise AssertionError(f"phase 6 bpp {p6['bpp']} is not within {BPP_RTOL} of the f32 "
                             f"plain model's {F32_PLAIN_BPP}")

    # A, B, C count from phase 4 (the default path), D and E from phase 5;
    # A, B, C and E in f32 from phase 6
    for k, phase, key in (("A", p4, "launches"), ("B", p4, "launches"), ("C", p4, "launches"),
                          ("D", p5, "launches"), ("E", p5, "launches"),
                          ("A", p6, "f32_launches"), ("B", p6, "f32_launches"),
                          ("C", p6, "f32_launches"), ("E", p6, "f32_launches")):
        n = phase["launches"][list(counted).index(k)]
        if n == 0:
            raise AssertionError(f"kernel {k} ({rows[k]['name']}) never launched on its path")
        rows[k][key] = n

    # ---- 7. training at full width
    t0 = time.time()
    p7 = training_phase(counted, slices)
    say(f"phase 7 training: {time.time() - t0:.2f} s")
    for k in "ABCDE":  # per full-width training step: A, B, C at (8, 8192), D, E at (8, 2048)
        at = "8192" if k in "ABC" else "2048"
        prof = p7[f"profile_{at}"].get(k, {})
        rows[k].update(train_launches=p7[f"launches_{at}"][k], train_step_nodes=[8, int(at)],
                       train_forward_ms=prof.get("forward_ms"),
                       train_backward_ms=prof.get("backward_ms"))
    say(json.dumps({"training": {k: v for k, v in p7.items() if not k.startswith("profile")}}))

    # ---- 8. the codec CLI on the card
    from scp_tpu_torch.native import metrics_native

    t0 = time.time()
    native_calls = metrics_native.calls
    p8 = cli_phase(model, counted, p4)
    p8_native_calls = metrics_native.calls - native_calls
    say(f"phase 8 codec CLI: {time.time() - t0:.2f} s")
    for k in "ABC":
        rows[k]["cli_launches"] = p8["launches"][k]
    say(json.dumps({"cli": p8}))

    # ---- 9. OctAttention serving (no kernel of A-E on its path)
    from scp_tpu_torch.tools.profile_train import reset_counts

    t0 = time.time()
    reset_counts(counted.values())
    p9 = octattn_phase()
    launches9 = {k: fn.launches for k, fn in counted.items()}
    if any(launches9.values()):
        raise AssertionError(f"phase 9 launched kernels of A-E: {launches9}")
    say(f"phase 9 OctAttention: {time.time() - t0:.2f} s; kernel launches A/B/C/D/E "
        f"{[launches9[k] for k in 'ABCDE']}")
    for k in "ABCDE":
        rows[k]["octattn_launches"] = 0
    say(json.dumps({"octattn": p9}))

    # ---- 10. OctAttention training (no kernel of A-E on its path either)
    t0 = time.time()
    reset_counts(counted.values())
    p10 = octattn_training_phase()
    launches10 = {k: fn.launches for k, fn in counted.items()}
    if any(launches10.values()):
        raise AssertionError(f"phase 10 launched kernels of A-E: {launches10}")
    say(f"phase 10 OctAttention training: {time.time() - t0:.2f} s; kernel launches A/B/C/D/E "
        f"{[launches10[k] for k in 'ABCDE']}")
    for k in "ABCDE":
        rows[k]["octattn_train_launches"] = 0
    say(json.dumps({"octattn_training": p10}))

    # ---- 11. EHEM's staged and full modes, test_gene -> CLIs -> psnr_test
    t0 = time.time()
    p11 = host_modes_phase(model, counted, slices, p4,
                           (p8["encode_timings"]["metrics"], p8_native_calls))
    say(f"phase 11 staged / full and the evaluation pipeline: {time.time() - t0:.2f} s")
    for k in "ABCDE":
        for mode in ("staged", "full"):
            rows[k][f"{mode}_launches"] = p11[mode]["launches"][k]
    say(json.dumps({"host_modes": p11}))
    p12 = phase12(model, counted, slices, p4)
    for k in "ABCDE":
        rows[k]["dp_rank_launches"] = [r[k] for r in p12["12a"]["ehem_bf16"]["rank_launches"]]
        rows[k]["shard_launches"] = [s["launches"].get(k, 0) for s in p12["12b"]["shards"]]

    # ---- 13. the last tools: the checkpoint importer, profile_codec, precompile
    p13 = phase13(model, counted, slices, p4, smi)
    for k in "ABCDE":
        rows[k]["imported_ckpt_launches"] = p13["13a"]["launches"][k]
        rows[k]["profile_launches"] = {t: r["launches"][k] for t, r in p13["13b"].items()}

    # ---- 14. the dynamic-graph EHEM (JAX's default DGCNN)
    p14 = dynamic_phase(counted, slices)
    for i, k in enumerate("ABCDE"):
        rows[k]["dynamic_launches"] = {t: p14[t]["launches"][i] for t in "abc"}
    rows["D"]["dynamic_arms"] = p14["b"]["arms"]
    rows["D"]["dynamic_wide_knn_ms"] = {t: p14[t]["knn_wide_ms"] for t in "abc"}
    say(json.dumps({"dynamic": {t: {k: v for k, v in r.items() if k != "sha256"}
                                for t, r in p14.items()}}))

    # ---- 15. the rANS coder's kernels
    p15 = rans_phase(slices, p4_rans, rans_res)
    chunk = p15["chunk"]
    rows["R"] = dict(
        name="rans_decode_group / rans_encode", route="cuda",
        source="scp_tpu_torch/ops/csrc/rans.cu",
        replaces="no pallas_call: lax.scan in scp_tpu/codec/rans.py (_decode_chunk, "
                 "_encode_chunk)", launches=p4_rans, max_abs_err=0,
        ms=chunk["decode_ms"], plain_ms=chunk["decode_plain_ms"],
        bound_ms=chunk["decode_bound_ms"], bound_by=chunk["bound_by"], library_ms=None,
        library_note="no PyTorch call codes rANS",
        bound_note="bytes bound; the serial chain of 64 dependent steps a chunk binds",
        **{k: v for k, v in p15.items() if k != "ptxas"})
    # ---- 16. the cached attention of OctAttention's KV-cache step
    p16 = cached_attn_phase()
    m = p16["128_f32"]
    rows["K"] = dict(
        name="cached_attn_split / cached_attn_combine", route="cuda",
        source="scp_tpu_torch/ops/csrc/cached_attn.cu",
        replaces="no pallas_call: einsums in scp_tpu/models/octattention.py (decode_step, "
                 "decode_insert)", launches=p9["cached_attn_launches"],
        max_abs_err=m["max_abs_err"], ms=m["ms"], plain_ms=m["plain_ms"],
        bound_ms=m["bound_ms"], bound_by=m["bound_by"], library_ms=m["library_ms"],
        library_note="the step's eager batched products (torch.bmm, softmax) with a host "
                     "position", shape=p16["shape"], ptxas=cattn_res,
        **{k: v for k, v in p16.items() if k not in ("shape", "128_f32")})
    say(f"total wall {time.time() - t_start:.1f} s")

    for k, prefixes in (("A", ("mlp_sm90<",)), ("B", ("gemm_sm90<",)), ("C", ("gemm_sm90<",)),
                        ("D", ("knn_topk_pruned<", "knn_topk_boxes<", "knn_topk_wide<"))):
        rows[k]["ptxas"] = {k2: v for k2, v in resources.items() if k2.startswith(prefixes)}
    rows["R"]["ptxas"] = rans_res
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    table = [{**{k: r[k] for k in keys}, **{k: v for k, v in r.items() if k not in keys}}
             for r in rows.values()]
    say(json.dumps({"kernels": table}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
