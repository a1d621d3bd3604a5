"""OctAttention codec: context-window entropy coding (port of
scp_tpu/codec/octattn_codec.py).

Three schedules, as in scp_tpu; the stream header's coding_mode names the
one a stream was written with, and decode follows it:

  * "full", the window schedule (reference compress, encode.py:23-82): the
    node rows of a level (or of the whole BFS stream, level_wise=False)
    are prefixed with context_size - 1 pad rows.  Fast mode: one forward
    per context_size-row window gives the probabilities of every node in
    it (causal and dual-stream masking make position j depend only on
    rows < j and not on node j's own occupancy).  Sequential mode: the
    window slides by one node and its last row is kept (reference
    `--sequential`).  The decoder runs one forward per node on the window
    the encoder used, with the rows not yet decoded left unknown: they
    carry an exact zero attention weight, so the logits are the
    encoder's bit for bit.  Host arithmetic coder.
  * "incr", the incremental (KV-cache) schedule on the host coder: chunks
    of context_size consecutive nodes of a level, no pad prefix, all
    chunks of a level in lockstep on a lane axis, one cached-attention
    step per node position (model.decode_step) and one cache insert
    (model.decode_insert).  Stream order is position-major: for each
    position j, the symbols of every chunk in chunk order.  One CDF-row
    fetch and one host-coder call per position at decode.
  * "rans", the same incremental schedule with the device rANS coder
    (codec/octattn_rans.py).  In the fused level schedule (the default)
    the whole position loop (context-row gather, model step, CDF
    quantization, rANS decode, symbol select, cache insert) runs on the
    device with no host sync, and each level's symbols are fetched once;
    `fused=False` is scp_tpu's per-position "steps" schedule, whose inputs
    are built on the host at every position.

The encoder of an incremental schedule runs the decoder's program: the
same step and insert ops on the same lane and step shapes, with the true
symbols in place of the decoded ones.  A batched full-window forward would
give the same logits only within rounding, so it never stands in for the
step loop.

What scp_tpu reads from the environment are constructor arguments here:
`mode` (SCP_OCTATTN_CODER: the incremental schedule's coder, "rans" or
"full"), `fused` (SCP_OCTATTN_FUSED) and `stream_cap` (SCP_OCTRANS_CAP).
The stream stamp (coding_params) names the compute dtype, the rans
schedule's `fused` and cap, and the port's backend; neither package
decodes the other's streams.

scp_tpu computes OctAttention with einsums and softmax, not with a Pallas
kernel.  On the card the model's step launches the cached-attention kernel
(ops/cached_attn.py) and replays captured graphs, and the fused rans
schedule runs its own part of each position as two more replays
(LevelGraphs); the stamp then names the kernel's numerics (cattn=split).
The CPU runs the same loop eagerly.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from scp_tpu_torch import ac
from scp_tpu_torch.codec import octattn_rans as orans
from scp_tpu_torch.codec import rans
from scp_tpu_torch.codec.ehem_codec import BACKEND, logits_to_cdf
from scp_tpu_torch.codec.slices import softmax_np
from scp_tpu_torch.core.octree import occupancy_to_child_octants
from scp_tpu_torch.models.octattention import OctAttention
from scp_tpu_torch.utils import profiling
from scp_tpu_torch.utils.cuda_graphs import capture

_PAD_OCC = 255


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class OctAttentionCodec:
    def __init__(self, model: OctAttention, mode: str = "rans", fused: bool = True,
                 stream_cap: int = orans.DEFAULT_CAP):
        """`mode` is the coder an incremental encode takes: "rans" (the
        device coder) or "full" (the host coder); the window schedules
        always take the host coder, and a decoder reads whichever schedule
        its caller names.  `fused` picks the rans schedule's level loop."""
        if mode not in ("rans", "full"):
            raise ValueError(f"mode must be 'rans' or 'full', got {mode!r}")
        self.model = model
        self.device = model.device
        self.csz = model.context_size
        self.mode = mode
        self.fused = bool(fused)
        self.stream_cap = int(stream_cap)
        self._graphs: dict = {}  # (lanes, decoder stream bytes or None) -> LevelGraphs

    @property
    def backend(self) -> str:
        return BACKEND if self.device.type == "cuda" else "torch-cpu"

    def coding_params(self, schedule: str = "rans") -> str:
        """Stamp of what changes the CDF rows or the stream layout; decode
        refuses a mismatch.  The fused-schedule fields exist for "rans"
        streams only, as in scp_tpu."""
        stamp = f"dtype={str(self.model.dtype).replace('torch.', '')}"
        if schedule == "rans":
            stamp += f";octsched={'fused' if self.fused else 'steps'}"
            if self.fused:
                stamp += f";cap={self.stream_cap}"
        if self.device.type == "cuda":  # the cached attention's kernel (split f32 sums)
            stamp += ";cattn=split"
        return stamp + f";backend={self.backend}"

    # -- level slicing (reference EncodeDataset, encode_dataset.py:32-55) --

    @staticmethod
    def split_levels(ctx: np.ndarray, level_wise: bool = True):
        """Raw (N, 4, 6) shard -> per-level (data(occ, level, octant), pos).
        level_wise=False returns the whole BFS stream as one slice (the
        reference obj-type default, encode_dataset.py:43)."""
        ctx = np.asarray(ctx)
        occ = ctx[:, :, 0].astype(np.int32) - 1
        node_level = ctx[:, -1, 1].astype(np.int32)
        max_level = int(node_level.max())
        data_all = np.stack(
            [occ, ctx[:, :, 1].astype(np.int32), ctx[:, :, 2].astype(np.int32)], axis=-1)
        pos_all = (ctx[:, :, 3:6] / float(2**max_level)).astype(np.float32)
        if not level_wise:
            return [(data_all, pos_all)], occ[:, -1].astype(np.int16), max_level
        levels = []
        for lv in range(1, max_level + 1):
            sel = node_level == lv
            levels.append((data_all[sel], pos_all[sel]))
        return levels, occ[:, -1].astype(np.int16), max_level

    # -- the window schedules ------------------------------------------------

    def _fwd(self, d: np.ndarray, p: np.ndarray) -> np.ndarray:
        """One window (csz, K, 3) -> its logits (csz, 255) on the host."""
        dd = torch.from_numpy(np.ascontiguousarray(d[None], np.int32)).to(self.device)
        pp = torch.from_numpy(np.ascontiguousarray(p[None], np.float32)).to(self.device)
        with torch.no_grad():
            return self.model(dd, pp)[0].float().cpu().numpy()

    def _pad_rows(self, m: int, k: int):
        d = np.zeros((m, k, 3), np.int32)
        d[:, :, 0] = _PAD_OCC
        return d, np.zeros((m, k, 3), np.float32)

    def _window(self, rows_d, rows_p, start):
        """Fixed-size window [start, start + csz), right-padded if short."""
        d = rows_d[start : start + self.csz]
        p = rows_p[start : start + self.csz]
        if d.shape[0] < self.csz:
            pad_d, pad_p = self._pad_rows(self.csz - d.shape[0], d.shape[1])
            d, p = np.concatenate([d, pad_d]), np.concatenate([p, pad_p])
        return d, p

    def encode(self, ctx: np.ndarray, sequential: bool = False, level_wise: bool = True):
        """-> (pdf (N, 255) f32, syms (N,), seconds); rows in BFS order."""
        levels, occ_stream, _ = self.split_levels(ctx, level_wise=level_wise)
        pdfs = []
        t0 = time.perf_counter()
        for data, pos in levels:
            n = data.shape[0]
            pad_d, pad_p = self._pad_rows(self.csz - 1, data.shape[1])
            rows_d, rows_p = np.concatenate([pad_d, data]), np.concatenate([pad_p, pos])
            probs = np.zeros((n, self.model.token_num), np.float32)
            if sequential:
                # sliding window: node i sits at the window's last position
                for i in range(n):
                    probs[i] = softmax_np(self._fwd(*self._window(rows_d, rows_p, i))[-1])
            else:
                for i in range(0, rows_d.shape[0], self.csz):
                    logits = self._fwd(*self._window(rows_d, rows_p, i))
                    rs, re = max(i, self.csz - 1), min(i + self.csz, self.csz - 1 + n)
                    if re > rs:  # the real nodes this window covers
                        probs[rs - (self.csz - 1) : re - (self.csz - 1)] = softmax_np(
                            logits[rs - i : re - i])
            pdfs.append(probs)
        return np.concatenate(pdfs, axis=0), occ_stream, time.perf_counter() - t0

    def encode_to_stream(self, ctx: np.ndarray, sequential: bool = False,
                         level_wise: bool = True):
        pdf, syms, elapsed = self.encode(ctx, sequential=sequential, level_wise=level_wise)
        stream, bits = ac.ArithmeticEncoder().encode(pdf, syms)
        return stream, bits, elapsed

    def _root_rows(self):
        k = self.model.ancestors
        anc_d = np.zeros((1, k - 1, 3), np.int32)
        anc_d[:, :, 0] = _PAD_OCC
        anc_p = np.zeros((1, k - 1, 3), np.int64)
        self_d = np.array([[[_PAD_OCC, 1, 1]]], np.int32)
        self_p = np.zeros((1, 1, 3), np.int64)
        return anc_d, anc_p, self_d, self_p

    @staticmethod
    def _next_level_rows(anc_d, self_d, pos_int, level_occ, level, max_level):
        """Child-context expansion of the decoders (role of the reference's
        decode.py:103-104 child queuing)."""
        filled = np.concatenate([anc_d, self_d], axis=1)
        filled[:, -1, 0] = level_occ
        pidx, octant = occupancy_to_child_octants(level_occ + 1)
        anc_d = filled[pidx][:, 1:, :]
        anc_p = pos_int[pidx][:, 1:, :]
        self_d = np.zeros((pidx.shape[0], 1, 3), np.int32)
        self_d[:, 0, 0] = _PAD_OCC
        self_d[:, 0, 1] = level + 1
        self_d[:, 0, 2] = octant + 1
        unit = np.int64(1) << np.int64(max_level - (level + 1) + 1)
        bits = np.stack([(octant >> 2) & 1, (octant >> 1) & 1, octant & 1],
                        axis=1).astype(np.int64)
        self_p = (pos_int[pidx][:, -1, :] + bits * unit)[:, None, :]
        return anc_d, anc_p, self_d, self_p

    def decode(self, dec: ac.ArithmeticDecoder, max_level: int,
               ground_truth: np.ndarray | None = None, sequential: bool = False,
               level_wise: bool = True) -> np.ndarray:
        """Node-by-node decode of a window-schedule stream (one forward per
        node), on the exact window the encoder used: fast mode's windows
        restart every csz rows of the padded stream, sequential mode's
        slide."""
        inv_scale = 1.0 / float(2**max_level)
        anc_d, anc_p, self_d, self_p = self._root_rows()
        codes = []
        decoded = 0
        # level_wise=False: one padded stream over all levels; level_wise=
        # True: the stream and its pad prefix restart at every level
        pad_d, pad_p = self._pad_rows(self.csz - 1, self.model.ancestors)
        rows_d, rows_p = pad_d, pad_p
        for level in range(1, max_level + 1):
            data = np.concatenate([anc_d, self_d], axis=1)
            pos_int = np.concatenate([anc_p, self_p], axis=1)
            m = data.shape[0]
            if level_wise:
                rows_d, rows_p = pad_d, pad_p
            level_base = rows_d.shape[0] - (self.csz - 1)
            rows_d = np.concatenate([rows_d, data])
            rows_p = np.concatenate([rows_p, pos_int.astype(np.float32) * inv_scale])
            level_occ = np.empty(m, np.int32)
            for node in range(m):
                padded_idx = level_base + node + self.csz - 1
                start = (padded_idx - (self.csz - 1) if sequential
                         else (padded_idx // self.csz) * self.csz)
                # rows past padded_idx are still unknown (occ 255)
                logits = self._fwd(*self._window(rows_d, rows_p, start))
                got = dec.decode_batch(softmax_np(logits[padded_idx - start])[None])
                if got.shape[0] == 0:
                    raise ValueError("bitstream exhausted mid-level: the stream was not "
                                     "encoded with the window schedule")
                sym = int(got[0])
                level_occ[node] = sym
                rows_d[padded_idx, -1, 0] = sym
                if ground_truth is not None and sym != int(ground_truth[decoded]):
                    raise AssertionError(f"decode mismatch at level {level} node {node}")
                decoded += 1
            codes.append(level_occ.astype(np.int16))
            if level == max_level:
                break
            anc_d, anc_p, self_d, self_p = self._next_level_rows(
                anc_d, self_d, pos_int, level_occ, level, max_level)
        return np.concatenate(codes)

    # -- the incremental schedule on the host coder ("incr") ----------------

    @staticmethod
    def _lane_count(c: int) -> int:
        """Pow2 bucket of the lane axis."""
        return orans.lane_bucket(c)

    def _lane_rows(self, data, pos, j, lanes, n):
        """Host (lanes, K, 3) inputs of position j; lanes past the level's
        chunks are pad rows."""
        d_j, p_j = self._pad_rows(lanes, data.shape[1])
        idx = np.arange(lanes) * self.csz + j
        live = idx < n
        d_j[live] = data[idx[live]]
        p_j[live] = pos[idx[live]]
        return d_j, p_j

    def _to_dev(self, *arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for a in arrays]

    def _incremental_level(self, data, pos, occ_or_decoder, decode: bool):
        """One level of the "incr" schedule; occ_or_decoder is the true
        occupancies (encode) or an ArithmeticDecoder (decode).  Returns
        (cdf rows u16, symbols) in position-major stream order."""
        n = data.shape[0]
        n_chunks = -(-n // self.csz)
        lanes = self._lane_count(n_chunks)
        cache = self.model.init_cache(lanes)
        rows_out, syms_out, pending = [], [], []
        for j in range(min(self.csz, n)):
            cnt = orans.active_count(n, self.csz, j)
            d_j, p_j = self._lane_rows(data, pos, j, lanes, n)
            dd, pp = self._to_dev(d_j, p_j)
            logits, qs = self.model.decode_step(dd, pp, cache, j)
            rows_dev = logits_to_cdf(logits)
            syms_j = np.full(lanes, _PAD_OCC, np.int32)
            if decode:
                host = rows_dev.cpu().numpy().astype(np.uint16)
                got = occ_or_decoder.decode_batch_quantized(host[:cnt])
                if got.shape[0] < cnt:
                    raise ValueError(
                        "bitstream exhausted mid-level: the stream was not encoded with the "
                        "incremental schedule (the header's coding_mode names the schedule)")
                syms_j[:cnt] = got
                rows_out.append(host[:cnt])
            else:
                # teacher forcing: no fetch inside the loop; rows come at the end
                pending.append((rows_dev, cnt))
                syms_j[:cnt] = occ_or_decoder[np.arange(cnt) * self.csz + j]
            syms_out.append(syms_j[:cnt])
            d_j[:, -1, 0] = syms_j
            (dk,) = self._to_dev(d_j)
            self.model.decode_insert(dk, pp, cache, j, qs)
        if not decode:
            rows_out = [r[:cnt].cpu().numpy().astype(np.uint16) for r, cnt in pending]
        return (np.concatenate(rows_out) if rows_out
                else np.zeros((0, self.model.token_num + 1), np.uint16),
                np.concatenate(syms_out) if syms_out else np.zeros(0, np.int32))

    @staticmethod
    def _position_major_order(n: int, csz: int) -> np.ndarray:
        """Level indices in the incremental stream's order."""
        j, c = np.meshgrid(np.arange(min(csz, n)), np.arange(-(-n // csz)), indexing="ij")
        idx = (c * csz + j).reshape(-1)
        return idx[idx < n]

    def encode_incremental(self, ctx: np.ndarray):
        """-> (cdf rows u16, syms int16, seconds) in the incremental stream
        order (position-major per level)."""
        levels, occ_stream, _ = self.split_levels(ctx)
        rows_all, syms_all = [], []
        t0 = time.perf_counter()
        off = 0
        for data, pos in levels:
            n = data.shape[0]
            rows, syms = self._incremental_level(data, pos, occ_stream[off : off + n],
                                                 decode=False)
            rows_all.append(rows)
            syms_all.append(syms)
            off += n
        return (np.concatenate(rows_all), np.concatenate(syms_all).astype(np.int16),
                time.perf_counter() - t0)

    def decode_incremental(self, dec: ac.ArithmeticDecoder, max_level: int,
                           ground_truth: np.ndarray | None = None) -> np.ndarray:
        inv_scale = 1.0 / float(2**max_level)
        anc_d, anc_p, self_d, self_p = self._root_rows()
        codes = []
        decoded = 0
        for level in range(1, max_level + 1):
            data = np.concatenate([anc_d, self_d], axis=1)
            pos_int = np.concatenate([anc_p, self_p], axis=1)
            pos = pos_int.astype(np.float32) * np.float32(inv_scale)
            n = data.shape[0]
            _, occ_pm = self._incremental_level(data, pos, dec, decode=True)
            level_occ = np.empty(n, np.int32)
            level_occ[self._position_major_order(n, self.csz)] = occ_pm
            if ground_truth is not None:
                want = ground_truth[decoded : decoded + n]
                if not (want == level_occ.astype(np.int16)).all():
                    raise AssertionError(f"incremental decode mismatch at level {level}")
            decoded += n
            codes.append(level_occ.astype(np.int16))
            if level == max_level:
                break
            anc_d, anc_p, self_d, self_p = self._next_level_rows(
                anc_d, self_d, pos_int, level_occ, level, max_level)
        return np.concatenate(codes)

    # -- the incremental schedule on the device coder ("rans") --------------

    def max_lane_bucket(self, ctx: np.ndarray) -> int:
        """Lane count of the OctRansEncoder: pow2 bucket of this cloud's
        largest per-level chunk count."""
        levels, _, _ = self.split_levels(ctx)
        return self._lane_count(max(-(-d.shape[0] // self.csz) for d, _ in levels))

    def _steps_bucket(self, max_m: int) -> int:
        """Pow2 bucket of the position count (the level buffers' shape)."""
        return orans.lane_bucket(max_m)

    def new_rans_encoder(self, k_lanes: int) -> orans.OctRansEncoder:
        return orans.OctRansEncoder(k_lanes, self.device, cap=self.stream_cap)

    def new_rans_decoder(self, payload: bytes) -> orans.OctRansDecoder:
        return orans.OctRansDecoder(payload, self.device, cap=self.stream_cap)

    def _level_bufs(self, data, pos_int, lanes):
        """The level padded to (lanes * csz, K, 3) device buffers: data as
        int32 (pad rows occ 255, the rest 0), positions as grid int32.  The
        loop normalizes in place (int -> f32 * inv_scale, equal bit for bit
        to the host division, the scale being a power of two)."""
        n, k = data.shape[0], data.shape[1]
        d, _ = self._pad_rows(lanes * self.csz, k)
        d[:n] = data
        p = np.zeros((lanes * self.csz, k, 3), np.int32)
        p[:n] = pos_int
        return self._to_dev(d, p)

    def _true_syms(self, occ, n: int, lanes: int) -> torch.Tensor:
        """(nsteps, lanes) position-major teacher symbols on the device;
        inactive slots 0."""
        nsteps = self._steps_bucket(min(self.csz, n))
        buf = np.zeros(lanes * self.csz, np.int64)
        buf[:n] = occ
        ts = np.zeros((max(nsteps, self.csz), lanes), np.int64)
        ts[: self.csz] = buf.reshape(lanes, self.csz).T
        (ts,) = self._to_dev(ts[:nsteps])
        return ts

    def _fused_inputs(self, d_buf, p_buf, inv_scale: float, lanes: int):
        """Position j's (lanes, K, 3) inputs gathered on the device from the
        level buffers (the fused schedule: nothing crosses the host link)."""
        return FusedInputs(d_buf, p_buf, inv_scale, lanes, self.csz)

    def _host_inputs(self, data, pos, n: int, lanes: int):
        """Position j's inputs built on the host and uploaded (scp_tpu's
        per-position "steps" schedule)."""
        return lambda j: self._to_dev(*self._lane_rows(data, pos, j, lanes, n))

    def _rans_level(self, inputs, n: int, lanes: int, true_syms=None, dec=None):
        """One level of the rans schedule, with no host sync inside: per
        position, the model step, the CDF rows, the symbol (decoded by `dec`,
        or true_syms[j] at encode), the cache insert.  Encode returns the
        (nsteps, lanes, 2) (cdf_low, freq) buffer, decode the (nsteps,
        lanes) symbols.  The codec's part of a position is PositionWork's;
        on a CUDA model with fused inputs it runs as two graph replays
        around the model's (LevelGraphs), elsewhere eagerly."""
        model = self.model
        max_m = min(self.csz, n)
        nsteps = self._steps_bucket(max_m)
        replays = model.step_replays
        if (self.device.type == "cuda" and isinstance(inputs, FusedInputs)
                and inputs.lanes == lanes):
            work = self._level_graphs(lanes, None if dec is None else dec.stream.shape[0])
            work.begin(inputs, n, true_syms, dec)
        else:
            work = PositionWork(self, inputs, n, lanes, nsteps, true_syms, dec)
        with profiling.span("octattn.level"):
            for j in range(max_m):
                d_j, p_j = work.gather(j)
                logits, qs = model.decode_step(d_j, p_j, work.cache, j)
                work.post(logits, d_j)
                model.decode_insert(d_j, p_j, work.cache, j, qs)
            if profiling.on():  # the span then ends with the level's work on the device
                _sync(self.device)
        profiling.count("octattn.positions", max_m)
        profiling.count("octattn.lanes", max_m * lanes)
        if model.step_replays > replays:  # never on the CPU
            profiling.count("octattn.graph_replays", model.step_replays - replays)
        return work.end(nsteps, dec)

    def _level_graphs(self, lanes: int, stream_bytes: int | None) -> "LevelGraphs":
        """The codec graphs of `lanes` lanes, for encode (stream_bytes None)
        or for a decoder's stream of that many bytes, captured at first use.
        A lane count first met captures both directions (the decode side at
        this codec's stream cap), so a warm encode readies the decode."""
        step = self.model.step_graphs(lanes)
        for key in dict.fromkeys([(lanes, stream_bytes), (lanes, None), (lanes, self.stream_cap)]):
            g = self._graphs.get(key)
            if g is None or g.step is not step:  # absent, or the model's graphs were redone
                self._graphs[key] = LevelGraphs(self, step, key[1])
        return self._graphs[(lanes, stream_bytes)]

    def encode_incremental_into(self, enc: orans.OctRansEncoder, ctx: np.ndarray) -> float:
        """Teacher-forced incremental encode into an open OctRansEncoder
        (several clouds may share one: the lane states persist across
        levels and subtrees).  Returns the seconds of the level loops; the
        payload is fetched in enc.finish()."""
        ctx = np.asarray(ctx)
        levels, occ_stream, max_level = self.split_levels(ctx)
        node_level = ctx[:, -1, 1].astype(np.int32)
        pos_int_all = ctx[:, :, 3:6].astype(np.int32)
        inv_scale = float(np.float32(1.0 / float(2**max_level)))
        t0 = time.perf_counter()
        off = 0
        with profiling.span("octattn.encode"):
            for li, (data, pos) in enumerate(levels):
                n = data.shape[0]
                occ = occ_stream[off : off + n].astype(np.int64)
                off += n
                lanes = self._lane_count(-(-n // self.csz))
                if self.fused:
                    inputs = self._fused_inputs(
                        *self._level_bufs(data, pos_int_all[node_level == li + 1], lanes),
                        inv_scale, lanes)
                else:
                    inputs = self._host_inputs(data, pos, n, lanes)
                sf = self._rans_level(inputs, n, lanes,
                                      true_syms=self._true_syms(occ, n, lanes))
                enc.append_level(sf, n, self.csz)
            _sync(self.device)
        return time.perf_counter() - t0

    def decode_incremental_rans(self, dec: orans.OctRansDecoder, max_level: int,
                                ground_truth: np.ndarray | None = None) -> np.ndarray:
        """Incremental decode from an open OctRansDecoder; one symbol fetch
        per level."""
        with profiling.span("octattn.decode"):
            inv_scale = float(np.float32(1.0 / float(2**max_level)))
            anc_d, anc_p, self_d, self_p = self._root_rows()
            codes = []
            decoded = 0
            for level in range(1, max_level + 1):
                data = np.concatenate([anc_d, self_d], axis=1)
                pos_int = np.concatenate([anc_p, self_p], axis=1)
                n = data.shape[0]
                lanes = self._lane_count(-(-n // self.csz))
                if lanes > dec.k:
                    raise ValueError(f"level {level} needs {lanes} lanes, the stream has {dec.k}")
                if self.fused:
                    inputs = self._fused_inputs(*self._level_bufs(data, pos_int, lanes),
                                                inv_scale, lanes)
                else:
                    pos = pos_int.astype(np.float32) * np.float32(inv_scale)
                    inputs = self._host_inputs(data, pos, n, lanes)
                syms = self._rans_level(inputs, n, lanes, dec=dec)
                with profiling.span("octattn.fetch"):
                    host = syms.cpu().numpy()  # the level's one fetch
                i = np.arange(n)  # node i is position i % csz of lane i // csz
                level_occ = host[i % self.csz, i // self.csz].astype(np.int32)
                if ground_truth is not None:
                    want = ground_truth[decoded : decoded + n]
                    if not (want == level_occ.astype(np.int16)).all():
                        raise AssertionError(f"incremental-rans decode mismatch at level {level}")
                decoded += n
                codes.append(level_occ.astype(np.int16))
                if level == max_level:
                    break
                anc_d, anc_p, self_d, self_p = self._next_level_rows(
                    anc_d, self_d, pos_int, level_occ, level, max_level)
            return np.concatenate(codes)


class FusedInputs:
    """The fused schedule's inputs of one level: position j's (lanes, K, 3)
    rows gathered on the device from the level buffers (data int32, grid
    positions int32 normalized to f32 by inv_scale).  j and inv_scale are
    host numbers, or device scalars (LevelGraphs' captured gather)."""

    def __init__(self, d_buf, p_buf, inv_scale, lanes: int, csz: int):
        self.d_buf, self.p_buf, self.inv_scale = d_buf, p_buf, inv_scale
        self.lanes, self.csz = lanes, csz
        self.lane = torch.arange(lanes, device=d_buf.device)

    def __call__(self, j):
        idx = self.lane * self.csz + j
        return self.d_buf[idx], self.p_buf[idx].float() * self.inv_scale


class PositionWork:
    """The codec's part of each position of one level, around the model's
    step and insert (which the level loop calls, so that whoever wraps
    them sees every position):

      * gather(j): position j's inputs;
      * post(logits, data): the step's logits to CDF rows; the symbol (the
        rANS decode step, updating the decoder's states and pointer in
        place, or the teacher symbol's (cdf_low, freq) at encode) into row
        j of the level's output, and into data's own occupancy for the
        insert (pad lanes 255); j += 1.

    j is an int64 device scalar, n a host int or one, so post is the same
    arithmetic whether it runs eagerly (here: the CPU, the host inputs of
    the "steps" schedule) or captured (LevelGraphs).  `cache` is the KV
    cache the level steps in."""

    def __init__(self, codec: "OctAttentionCodec", inputs, n, lanes: int, nsteps: int,
                 true_syms, dec):
        dev = codec.device
        self.csz, self.inputs, self.n, self.true_syms = codec.csz, inputs, n, true_syms
        self.lane = torch.arange(lanes, device=dev)
        self.j = torch.zeros((), dtype=torch.int64, device=dev)
        self.out = torch.zeros((nsteps, lanes) if dec is not None else (nsteps, lanes, 2),
                               dtype=torch.int64, device=dev)
        self.coder = None if dec is None else (dec.states, dec.ptr, dec.stream)
        self.cache = codec.model.init_cache(lanes)

    def gather(self, j: int):
        return self.inputs(j)

    def post(self, logits, data) -> None:
        self.select(logits, data)

    def select(self, logits, data) -> None:
        rows = logits_to_cdf(logits)
        j, csz = self.j, self.csz
        n_act = torch.div(self.n - j + (csz - 1), csz, rounding_mode="floor")  # active_count
        at = j.view(1)
        if self.coder is not None:
            sym = orans.decode_step_core(*self.coder, rows, n_act)[: self.lane.shape[0]]
            self.out.index_copy_(0, at, sym[None])
        else:
            sym = self.true_syms.index_select(0, at)[0]
            self.out.index_copy_(0, at, rans.gather_start_freq(rows, sym)[None])
        data[:, -1, 0] = torch.where(self.lane < n_act, sym, _PAD_OCC).to(data.dtype)
        j.add_(1)

    def end(self, nsteps: int, dec) -> torch.Tensor:
        return self.out


class LevelGraphs(PositionWork):
    """PositionWork of one lane count and direction as two CUDA graphs over
    static buffers, replayed at every position of every level of that lane
    count: gather writes the model graphs' static inputs (StepGraphs) from
    the level buffers, post is select on the step's logits.  j, n and the
    positions' scale are device scalars, so nothing in the loop syncs the
    host.  The level's tensors (level buffers, teacher symbols, the
    decoder's states, pointer and stream) are copied in once a level
    (begin) and the output and the decoder's state out once (end); the
    level steps in the model graphs' own caches."""

    def __init__(self, codec: "OctAttentionCodec", step, stream_bytes: int | None):
        model, dev, csz = codec.model, codec.device, codec.csz
        self.step = step
        self.csz = csz
        lanes = step.data.shape[0]
        steps = orans.lane_bucket(csz)
        with torch.cuda.device(dev):
            buf = (lanes * csz, model.ancestors, 3)
            self.inputs = FusedInputs(torch.zeros(buf, dtype=torch.int32, device=dev),
                                      torch.zeros(buf, dtype=torch.int32, device=dev),
                                      torch.ones((), dtype=torch.float32, device=dev),
                                      lanes, csz)
            self.n = torch.zeros((), dtype=torch.int64, device=dev)
            self.j = torch.zeros((), dtype=torch.int64, device=dev)
            self.lane = torch.arange(lanes, device=dev)
            self.logits = torch.zeros((lanes, model.token_num), dtype=torch.float32, device=dev)
            if stream_bytes is None:
                self.out = torch.zeros((steps, lanes, 2), dtype=torch.int64, device=dev)
                self.true_syms = torch.zeros((steps, lanes), dtype=torch.int64, device=dev)
                self.coder = None
            else:
                self.out = torch.zeros((steps, lanes), dtype=torch.int64, device=dev)
                self.true_syms = None
                self.coder = (torch.full((lanes,), rans.RANS_L, dtype=torch.int64, device=dev),
                              torch.zeros((), dtype=torch.int64, device=dev),
                              torch.zeros(stream_bytes, dtype=torch.uint8, device=dev))
            data, pos = step.data, step.pos

            def gather():
                d_j, p_j = self.inputs(self.j)
                data.copy_(d_j)
                pos.copy_(p_j)

            self.gather_graph, _ = capture(gather)
            self.post_graph, _ = capture(lambda: self.select(self.logits, data))
        profiling.count("octattn.graph_captures", 2)

    def begin(self, inputs: FusedInputs, n: int, true_syms, dec) -> None:
        self.inputs.d_buf.copy_(inputs.d_buf)
        self.inputs.p_buf.copy_(inputs.p_buf)
        self.inputs.inv_scale.fill_(inputs.inv_scale)
        self.n.fill_(n)
        self.j.zero_()
        self.out.zero_()
        if dec is None:
            self.true_syms[: true_syms.shape[0]].copy_(true_syms)
        else:
            states, ptr, stream = self.coder
            states.copy_(dec.states[: states.shape[0]])
            ptr.copy_(dec.ptr)
            stream.copy_(dec.stream)
        self.cache = self.step.own_cache()

    def gather(self, j: int):
        self.gather_graph.replay()
        return self.step.data, self.step.pos

    def post(self, logits, data) -> None:
        self.logits.copy_(logits)
        self.post_graph.replay()

    def end(self, nsteps: int, dec) -> torch.Tensor:
        if dec is not None:
            states, ptr, _ = self.coder
            dec.states[: states.shape[0]].copy_(states)
            dec.ptr.copy_(ptr)
        return self.out[:nsteps].clone()
