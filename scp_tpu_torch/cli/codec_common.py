"""Shared encode/decode session logic of the port's codec CLIs (the twin of
scp_tpu/cli/codec_common.py: EHEM in its three coding modes, OctAttention
in its three schedules).

Handles: the run config, the weights, the preprocessing cache (`_meta.npy`
compatible with the reference's, encode_dataset_ehem.py:132, and the
`_manifest.npz` grids), single- and multi-level (3-subtree) encoding,
bitstream + sidecar output, and full decode back to a Cartesian .ply.

A run dir is the port's: `config.yaml` and a checkpoint under `ckpt/`,
either the trainer's `torch.save` file (train/checkpoints.py::save) or a
bench `.npz` (the JAX package's format).  scp_tpu's orbax checkpoint
directories are refused: the card's machine has no orbax.

What scp_tpu reads from the environment are constructor arguments here:
`dtype` (SCP_CODEC_DTYPE: bf16 for EHEM and f32 for OctAttention by
default, as there), EHEM's `ehem_mode` (SCP_CODEC_MODE: rans, staged or
full), `static_knn`, `pallas_knn`, `pallas_attn`, OctAttention's `octattn_coder` (SCP_OCTATTN_CODER), `octattn_fused`
(SCP_OCTATTN_FUSED) and `octrans_cap` (SCP_OCTRANS_CAP); and `device`
(cuda unless told otherwise).

An OctAttention stream's header names its schedule (coding_mode "rans":
the incremental schedule on the device rANS coder; "incr": the same on the
host coder; "full": the window schedule on the host coder), and decode
follows it.  The window schedule's stamp also names its window (fast or
sequential) and level_wise, which scp_tpu leaves to the decoder's flags:
a decode with other flags is refused instead of desynchronizing the
coder.  An EHEM stream's header names its coding mode, and decode rebuilds
the codec in that mode.
"""

from __future__ import annotations

import os
import time
from pathlib import Path

import numpy as np
import torch

from scp_tpu_torch import ac, resolve_device
from scp_tpu_torch.codec.bitstream import (
    StreamHeader,
    pack_stream,
    reference_style_name,
    unpack_stream,
)
from scp_tpu_torch.codec.ehem_codec import MODES, EHEMCodec
from scp_tpu_torch.codec.octattn_codec import OctAttentionCodec
from scp_tpu_torch.codec.octattn_rans import DEFAULT_CAP
from scp_tpu_torch.codec.slices import split_levels
from scp_tpu_torch.config import load_run_config
from scp_tpu_torch.core.octree import deoctree
from scp_tpu_torch.core.pointcloud import read_points, write_ply
from scp_tpu_torch.core.preprocess import ford_qs, kitti_qs, preprocess_points
from scp_tpu_torch.core.quantize import QuantGrid
from scp_tpu_torch.metrics import PEAKS, chamfer, d1_d2_psnr
from scp_tpu_torch.models import build_model
from scp_tpu_torch.train import checkpoints
from scp_tpu_torch.weights import load_into

MULLEVEL_PATHS = ([0, 0], [0, 1], [1])  # near/mid/far (reference test_gene.py:24-65)

# MVUB upper-body sequences need the axis rotation (reference
# data_preprocess.py:242-243)
MVUB_NAMES = (
    "andrew10", "david10", "phil10", "phil9", "ricardo10", "ricardo9", "sarah10",
)
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def shard_name(ori_file: str, data_type: str) -> str:
    p = Path(ori_file)
    if data_type == "kitti":
        return p.parent.name + p.stem
    return p.stem


def level_qs(data_type: str, lidar_level: int) -> float:
    return kitti_qs(lidar_level) if data_type != "ford" else ford_qs(lidar_level)


def _level_counts(ctx: np.ndarray, max_level: int) -> np.ndarray:
    """Per-level node counts of one (N, 4, 6) shard for the stream header."""
    return np.bincount(ctx[:, -1, 1].astype(np.int64),
                       minlength=max_level + 1)[1 : max_level + 1].astype(np.int64)


def load_weights(model: torch.nn.Module, ckpt_path: str) -> torch.nn.Module:
    """Fill `model` from a port checkpoint: the trainer's `torch.save`
    file or a bench `.npz`."""
    if os.path.isdir(ckpt_path):
        raise ValueError(
            f"{ckpt_path} is a directory (an orbax checkpoint of scp_tpu?): the port "
            "reads a torch.save file of its trainer or a bench .npz; orbax is not "
            "available where the port runs")
    if ckpt_path.endswith(".npz"):
        return load_into(model, checkpoints.load_params_npz(ckpt_path))
    payload = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    model.load_state_dict(payload["model"], strict=True)
    return model


class CodecSession:
    """One model + codec serving encode_file / decode_file calls.
    `timings` holds the seconds of the last call, by stage."""

    def __init__(self, ckpt_path: str, run_dir: str, *, dtype: str | None = None,
                 ehem_mode: str | None = None, static_knn: bool = False,
                 pallas_knn: bool = False, pallas_attn: bool = False,
                 octattn_coder: str = "rans", octattn_fused: bool = True,
                 octrans_cap: int = DEFAULT_CAP, device=None):
        """`ehem_mode` is EHEM's coding mode (one of MODES; rans when
        None); an OctAttention run refuses it."""
        self.cfg = load_run_config(run_dir)
        self.is_ehem = str(self.cfg.model.class_name).upper().startswith("EHEM")
        if not self.is_ehem and ehem_mode is not None:
            raise ValueError("--ehem-mode is EHEM's coding mode; an OctAttention run picks "
                             "its schedule with --incremental / --octattn-coder")
        # EHEM codes in bf16 by default, OctAttention in f32 (scp_tpu's
        # SCP_CODEC_DTYPE defaults)
        dtype = dtype or ("bf16" if self.is_ehem else "f32")
        if dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got {dtype!r}")
        self.device = resolve_device(device)
        # parameters stay f32; dtype sets the compute dtype, and is stamped
        # in coding_params so an encode/decode mismatch is refused
        switches = (dict(static_knn=static_knn, pallas_knn=pallas_knn, pallas_attn=pallas_attn)
                    if self.is_ehem else {})
        self.model = build_model(self.cfg, DTYPES[dtype], device=self.device, **switches)
        load_weights(self.model, ckpt_path)
        if self.is_ehem:
            self.codec = EHEMCodec(self.model, self.cfg.model.context_size,
                                   mode=ehem_mode or "rans")
        else:
            self.codec = OctAttentionCodec(self.model, mode=octattn_coder, fused=octattn_fused,
                                           stream_cap=octrans_cap)
        self.timings: dict[str, float] = {}

    def octattn_schedule(self, incremental: bool) -> str:
        """The coding_mode an OctAttention encode writes."""
        if not incremental:
            return "full"
        return "rans" if self.codec.mode == "rans" else "incr"

    def _coding_params(self, schedule: str, sequential: bool, level_wise: bool) -> str:
        if self.is_ehem:
            return self.codec.coding_params()
        stamp = self.codec.coding_params(schedule)
        if schedule == "full":
            stamp += f";window={'sequential' if sequential else 'fast'};level_wise={int(level_wise)}"
        return stamp

    def _tick(self, stage: str, t0: float) -> float:
        now = time.perf_counter()
        self.timings[stage] = self.timings.get(stage, 0.0) + now - t0
        return now

    # -- preprocessing -----------------------------------------------------

    @staticmethod
    def _derive_grid(ref_pts, ori_file, data_type, lidar_level, system):
        """Reconstruct the QuantGrid a preprocessing run would have used
        (grid parameters depend only on the points, system and step size —
        not on the octree)."""
        from scp_tpu_torch.core.preprocess import rotate_axes
        from scp_tpu_torch.core.quantize import make_grid

        if data_type == "obj":
            p = ref_pts
            if any(n in ori_file for n in MVUB_NAMES):
                p = rotate_axes(p)
            return make_grid(p, system="cart", qs=1.0, offset="min")
        qs = level_qs(data_type, lidar_level)
        return make_grid(
            ref_pts,
            system=system,
            qs=qs,
            offset=(-200 if data_type == "kitti" else -(2**17))
            if system == "cart"
            else 0,
        )

    @staticmethod
    def _preproc_one(pts, ori_file, data_type, lidar_level, system, morton_path=None):
        if data_type == "obj":
            # dense object clouds (MPEG/MVUB): unit grid, min offset, MVUB
            # sequences rotated to a common orientation (reference
            # encode_dataset.py:69-77, data_preprocess.py:37-39)
            rotate = any(n in ori_file for n in MVUB_NAMES)
            return preprocess_points(pts, system="cart", qs=1.0, offset="min",
                                     rotation=rotate)
        qs = level_qs(data_type, lidar_level)
        return preprocess_points(
            pts,
            system=system,
            qs=qs,
            offset=(-200 if data_type == "kitti" else -(2**17))
            if system == "cart"
            else 0,
            morton_path=morton_path,
        )

    @staticmethod
    def _load_normals(ori_file, data_type, normals_dir):
        """Original-cloud normals for D2 PSNR (reference pt.py:68-79 feeds
        pc_error a normals ply via -n).  Looked up by stem in normals_dir
        (the layout of scp_tpu's tools/gene_normals.py)."""
        if not normals_dir:
            return None
        from scp_tpu_torch.tools.gene_normals import read_normals_ply

        for cand in (Path(ori_file).stem, shard_name(ori_file, data_type)):
            p = os.path.join(normals_dir, cand + ".ply")
            if os.path.exists(p):
                _, normals = read_normals_ply(p)
                return normals
        raise FileNotFoundError(
            f"no normals ply for {ori_file!r} under {normals_dir!r}"
        )

    def preproc(
        self, ori_file, data_type, lidar_level, system, preproc_path="",
        mullevel=False, normals_dir="",
    ):
        """Returns (results list, metrics dict). Uses cached shards when a
        preproc_path is supplied (reference encode_dataset_ehem.py:126-135).
        """
        t = time.perf_counter()
        name = shard_name(ori_file, data_type)
        if preproc_path:
            base = os.path.join(preproc_path, name)
            suffixes = ["_0_0", "_0_1", "_1"] if mullevel else [""]
            ctxs = [np.load(base + s + ".npy") for s in suffixes]
            meta = np.load(base + "_meta.npy")
            ref_pts = read_points(ori_file)
            if os.path.exists(base + "_manifest.npz"):
                manifest = np.load(base + "_manifest.npz", allow_pickle=True)
                grids = [
                    QuantGrid(
                        system=str(manifest["system"]),
                        qs=manifest["qs"][i],
                        offset=manifest["offset"][i],
                        bin_num=int(manifest["bin_num"][i]),
                    )
                    for i in range(len(ctxs))
                ]
                z_offset = float(meta[2]) if len(meta) > 2 else 0.0
            else:
                # Reference-style cache (shards + `_meta.npy` only,
                # reference encode_dataset_ehem.py:126-135): rebuild the
                # grids exactly as preprocessing would, from the original
                # points + (type, level, system) (the reference re-derives
                # qs/bin_num the same way, encode_dataset_ehem.py:136-171).
                grids = [
                    self._derive_grid(
                        ref_pts, ori_file, data_type,
                        lidar_level + (j if mullevel else 0), system,
                    )
                    for j in range(len(ctxs))
                ]
                z_offset = float(grids[0].offset[2])
            results = list(zip(ctxs, grids))
            # cached-shard runs never measure PSNR (reference `_meta.npy`
            # cache stores only [bin_num, chamfer]); mark N/A as NaN so the
            # results txt can't confuse "not measured" with a measured zero
            metrics = {
                "bin_num": int(meta[0]),
                "chamfer": float(meta[1]),
                "z_offset": z_offset,
                "psnr_d1": float("nan"),
                "psnr_d2": float("nan"),
                "ref_points": ref_pts,
            }
            self._tick("file_io", t)
            return results, metrics

        ref_pts = read_points(ori_file)
        t = self._tick("file_io", t)
        results = []
        octree_s = 0.0
        if mullevel:
            recons = []
            for j, mp in enumerate(MULLEVEL_PATHS):
                res = self._preproc_one(
                    ref_pts, ori_file, data_type, lidar_level + j, system, morton_path=mp
                )
                octree_s += res.octree_s
                results.append((res.context, res.grid))
                recons.append(res.recon_points)
                if j == 0:
                    first = res
            recon = np.vstack(recons)
        else:
            first = self._preproc_one(ref_pts, ori_file, data_type, lidar_level, system)
            octree_s = first.octree_s
            results.append((first.context, first.grid))
            recon = first.recon_points
        t = self._tick("preprocess", t)
        self.timings["preprocess"] -= octree_s
        self.timings["octree"] = self.timings.get("octree", 0.0) + octree_s

        peak = PEAKS.get(data_type, 59.70)
        normals = self._load_normals(ori_file, data_type, normals_dir)
        t = self._tick("file_io", t)
        psnr_d1, psnr_d2 = d1_d2_psnr(ref_pts, recon, peak, normals=normals)
        metrics = {
            "bin_num": first.bin_num,
            "chamfer": chamfer(ref_pts.copy(), recon.copy()),
            "z_offset": first.z_offset,
            "psnr_d1": psnr_d1,
            "psnr_d2": psnr_d2 if normals is not None else float("nan"),
            "ref_points": ref_pts,
        }
        self._tick("metrics", t)
        return results, metrics

    # -- encode --------------------------------------------------------------

    def encode_file(
        self,
        ori_file,
        out_dir,
        data_type="kitti",
        lidar_level=12,
        system="spher",
        preproc_path="",
        sequential=False,
        incremental=False,
        mullevel=False,
        level_wise=True,
        normals_dir="",
    ) -> dict:
        """`sequential`, `incremental` and `level_wise` pick OctAttention's
        schedule; an EHEM run codes level by level in its coding mode and
        refuses the first two (they would be ignored)."""
        if self.is_ehem and (sequential or incremental):
            raise ValueError("--sequential and --incremental are OctAttention schedules; an "
                             "EHEM run codes level by level (see --ehem-mode)")
        self.timings = {}
        results, metrics = self.preproc(
            ori_file, data_type, lidar_level, system, preproc_path, mullevel,
            normals_dir=normals_dir,
        )
        angular = system in ("spher", "cylin")

        t = time.perf_counter()
        schedule = self.codec.mode if self.is_ehem else self.octattn_schedule(incremental)
        if self.is_ehem:
            enc = self.codec.new_stream_encoder()
        elif schedule == "rans":
            enc = self.codec.new_rans_encoder(
                max(self.codec.max_lane_bucket(ctx) for ctx, _ in results))
        else:
            enc = ac.StreamingEncoder()
        sub_sizes, mms, max_levels, lvl_sizes = [], [], [], []
        for ctx, _grid in results:
            if self.is_ehem:
                # deepest-level clip applied symmetrically at encode
                # (split_levels + in-program) and decode (header stamp) —
                # reference encode_dataset_ehem.py:86 / Embed(19) bound
                slices = split_levels(ctx, angular=angular, lidar_level_clip=lidar_level)
                self.codec.encode_into(enc, slices, lidar_clip=lidar_level)
                mms.append(np.array(slices.pos_mm, np.int64))
                max_levels.append(slices.max_level)
                sub_sizes.append(slices.occ_stream.shape[0])
                lvl_sizes.append(np.asarray(slices.level_sizes, np.int64))
                continue
            if schedule == "rans":
                self.codec.encode_incremental_into(enc, ctx)
            elif schedule == "incr":
                rows, syms, _ = self.codec.encode_incremental(ctx)
                enc.append_quantized(rows, syms)
            else:
                pdf, syms, _ = self.codec.encode(ctx, sequential=sequential,
                                                 level_wise=level_wise)
                enc.append(pdf, syms)
            _, occ, ml = self.codec.split_levels(ctx)
            max_levels.append(ml)
            sub_sizes.append(occ.shape[0])
            mms.append(np.zeros((ml, 2), np.int64))
            lvl_sizes.append(_level_counts(ctx, ml))
        payload, bits, n_sym = EHEMCodec.finish_stream(enc)
        elapsed = time.perf_counter() - t
        t = self._tick("model_coder", t)

        header = StreamHeader(
            n_sym=int(n_sym),
            max_level=int(sum(max_levels)) if mullevel else int(max_levels[0]),
            system=system,
            bin_num=int(metrics["bin_num"]),
            z_offset=float(metrics["z_offset"]),
            lidar_clip=int(lidar_level),
            qs_rho=float(level_qs(data_type, lidar_level)),
            pos_mm=np.concatenate(mms, axis=0) if mms else np.zeros((0, 2), np.int64),
            subtree_sizes=tuple(sub_sizes),
            coding_mode=schedule,
            backend=self.codec.backend,
            coding_params=self._coding_params(schedule, sequential, level_wise),
            subtree_levels=tuple(max_levels),
            level_sizes=np.concatenate(lvl_sizes),
            grid_qs=np.stack(
                [np.broadcast_to(np.asarray(g.qs, np.float64), (3,)) for _, g in results]
            ),
            grid_offset=np.stack(
                [np.broadcast_to(np.asarray(g.offset, np.float64), (3,)) for _, g in results]
            ),
            grid_bin_num=np.array([g.bin_num for _, g in results], np.int64),
        )
        os.makedirs(out_dir, exist_ok=True)
        stem = shard_name(ori_file, data_type)
        binname = reference_style_name(
            stem, system, header.max_level, header.bin_num, header.z_offset
        )
        outputfile = os.path.join(out_dir, binname)
        with open(outputfile, "wb") as f:
            f.write(pack_stream(header, payload))
        # decode manifest sidecar (per-subtree grids + level maxima)
        np.savez(
            outputfile + ".manifest.npz",
            qs=np.stack([g.qs for _, g in results]),
            offset=np.stack([g.offset for _, g in results]),
            bin_num=np.array([g.bin_num for _, g in results]),
            system=system,
            max_levels=np.array(max_levels),
        )
        self._tick("file_io", t)

        pt_num = metrics["ref_points"].shape[0]
        oct_num = int(sum(sub_sizes))
        return {
            "outputfile": outputfile,
            "seconds": elapsed,  # model + coder wall, payload fetched
            "pt_num": pt_num,
            "oct_num": oct_num,
            "bits": bits,
            "bit_per_oct": bits / oct_num,
            "bpp": bits / pt_num,
            "chamfer": metrics["chamfer"],
            "psnr_d1": metrics["psnr_d1"],
            "psnr_d2": metrics.get("psnr_d2", 0.0),
        }

    # -- decode --------------------------------------------------------------

    def decode_file(self, binfile, out_ply=None, ground_truth: np.ndarray | None = None,
                    sequential=False, level_wise=True):
        """Bitstream -> occupancy codes -> Cartesian points (+ .ply).  The
        header's coding_mode picks the schedule; `sequential` and
        `level_wise` must be the window-schedule encoder's (its stamp names
        them)."""
        self.timings = {}
        t = time.perf_counter()
        with open(binfile, "rb") as f:
            header, payload = unpack_stream(f.read())
        t = self._tick("file_io", t)
        if header.backend and header.backend != self.codec.backend:
            # encoder and decoder must run the same float math: another
            # backend's CDF rows differ and the coder would desync
            raise RuntimeError(
                f"bitstream was encoded on backend {header.backend!r}; decoding on "
                f"{self.codec.backend!r} is not supported"
            )
        mode = header.coding_mode
        if self.is_ehem and mode != self.codec.mode:
            if mode not in MODES:
                raise ValueError(f"bitstream coded in mode {mode!r}, which is no EHEM coding "
                                 f"mode {MODES}")
            # the header names the coding mode (scp_tpu/cli/codec_common.py:422-431)
            self.codec = EHEMCodec(self.model, self.cfg.model.context_size, mode=mode)
        if not self.is_ehem and mode not in ("rans", "incr", "full"):
            raise ValueError(f"bitstream coded in mode {mode!r}, which is no OctAttention "
                             "schedule ('rans', 'incr' or 'full')")
        want_params = self._coding_params(mode, sequential, level_wise)
        if header.coding_params and header.coding_params != want_params:
            # these settings change the CDF rows or the stream layout: a
            # mismatch would desync the coder
            raise RuntimeError(
                f"bitstream coded with {header.coding_params!r} but this session runs "
                f"{want_params!r}; pass the encoder's --dtype"
                + (" / --static-knn / --pallas-knn / --pallas-attn" if self.is_ehem else
                   " / --octattn-steps / --octrans-cap / --sequential / --level_wise")
            )
        # per-subtree grids, octree depths and per-level node counts all
        # live in the header: a bare .bin decodes with no sidecar
        max_levels = header.subtree_levels
        grids = header.grids()
        if self.is_ehem:
            dec = self.codec.new_stream_decoder(payload, header.n_sym)
        elif mode == "rans":
            dec = self.codec.new_rans_decoder(payload)
        else:
            dec = ac.ArithmeticDecoder(payload, header.n_sym)

        start = time.perf_counter()
        parts = []
        mm_off = lvl_off = gt_off = 0
        for i, ml in enumerate(max_levels):
            ml = int(ml)
            mm = header.pos_mm[mm_off : mm_off + ml]
            mm_off += ml
            sizes_i = header.level_sizes[lvl_off : lvl_off + ml]
            lvl_off += ml
            gt = None
            if ground_truth is not None:
                gt = ground_truth[gt_off : gt_off + int(header.subtree_sizes[i])]
            gt_off += int(header.subtree_sizes[i])
            t = time.perf_counter()
            if self.is_ehem:
                codes = self.codec.decode(
                    dec,
                    ml,
                    mm,
                    angular=header.angular,
                    lidar_clip=int(header.lidar_clip),
                    ground_truth=gt,
                    level_sizes=sizes_i,
                )
            elif mode == "rans":
                codes = self.codec.decode_incremental_rans(dec, ml, ground_truth=gt)
            elif mode == "incr":
                codes = self.codec.decode_incremental(dec, ml, ground_truth=gt)
            else:
                codes = self.codec.decode(dec, ml, ground_truth=gt, sequential=sequential,
                                          level_wise=level_wise)
            t = self._tick("model_coder", t)
            parts.append(grids[i].from_grid(deoctree(codes.astype(np.int64) + 1)))
            self._tick("deoctree", t)
        elapsed = time.perf_counter() - start
        out_points = np.vstack(parts).astype(np.float32)
        if out_ply:
            t = time.perf_counter()
            write_ply(out_ply, out_points)
            self._tick("file_io", t)
        return out_points, elapsed
