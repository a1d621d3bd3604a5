"""EHEM wavefront codec (port of scp_tpu/codec/ehem_codec.py), in its
three stream modes.

Coding order is level-major: per octree level all group-1 (even) symbols
in chunk order, then all group-2 (odd) symbols.  Full context chunks ride
the batch axis of one phase call, and encoder and decoder run the phase
calls on identical inputs, so their CDF rows agree bit for bit.

  * "rans" (default): the device rANS coder (codec/rans.py).  The
    quantized CDF rows stay on the device; contexts and positions are
    derived level by level on the device by the same expansion on both
    sides (the call plan `_call_plan`).
  * "staged": each 255-way symbol is coded as two 16-way nibble stages
    with exact conditionals (codec/staged.py) on the host arithmetic
    coder (scp_tpu_torch/ac).  The encoder fetches the 8-byte coding
    intervals per node, the decoder two 17-entry rows.  Stream order per
    level: evens-hi, evens-lo, odds-hi, odds-lo (chunk order within each).
  * "full": one 256-entry CDF row per node on the host coder.  Stream
    order per level: evens, then odds, in chunk order.

The staged and full modes pack contexts on the host (uint8 channels,
uint16 positions), chunk by chunk in calls of three shapes
(`_phase1_level`), and run every level through the model; their decoder
expands the tree on the host.  Encoder and decoder call the same phase
functions on tensors of one shape and layout.

The stream is stamped with the port's own backend and coding params:
the port's float math (its kernels, exact top-k) differs from the TPU's,
so neither package decodes the other's streams; the two are compared at
the level of logits, CDF rows, coder bytes and bpp.

Several `encode_into` calls on one encoder write one stream that `decode`
reads back subtree by subtree (the multi-level CLI path), in every mode.

Multi-device coding (scp_tpu's EHEMCodec(mesh=...), rans mode only):
`devices` lists the devices of the lane shards, such as ["cuda:0", ...,
"cuda:3"] (a device may repeat).  The model is replicated on each, the
call plan keeps leftover lane counts divisible by their number
(`_call_plan(..., mesh_mult)`), and a grouped phase call whose lane count
they divide runs one contiguous lane slice per device; its CDF rows are
gathered to devices[0], where the expansion and the rANS coder run (the
lane scan is sequential in the stream, as scp_tpu keeps it on one
device).  A sharded call runs its slices with other batch sizes than the
unsharded one, so its rows may differ in the last bit: the stamp names the
device count, and a decoder with another count refuses the stream.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from scp_tpu_torch import ac
from scp_tpu_torch.codec import rans
from scp_tpu_torch.codec.slices import LevelSlices, normalize_positions, pad_rows, split_levels
from scp_tpu_torch.codec.staged import gather_cond_rows, intervals, staged_cdfs
from scp_tpu_torch.core.octree import occupancy_to_child_octants
from scp_tpu_torch.models.ehem import EHEM
from scp_tpu_torch.ops.knn_topk import takes_pruned_arm
from scp_tpu_torch.utils import profiling

# the attention numerics stamped in coding_params
ATTN_NUMERICS = "normalized"
# the bf16 GEMMs of the Swin sublayers stamped in coding_params: the Hopper
# wgmma kernels (ops/csrc/gemm_sm90.cuh, mlp.cu), which sum in another
# order than the WMMA kernel before them
GEMM_NUMERICS = "sm90"
# kernel D's wide arm stamped in coding_params: its feature graphs' scores
# take each dot product exactly, rounded once to f32 (ops/csrc/knn_topk.cu
# rescores on the CUDA cores what its tensor cores let through), where the
# brute-force arm before it summed an f32 chain
KNN_WIDE_NUMERICS = "exactdot"
BACKEND = "torch-cuda"  # stream stamp of the port (the CPU path stamps torch-cpu)
MODES = ("rans", "staged", "full")


def logits_to_cdf(logits: torch.Tensor) -> torch.Tensor:
    """Softmax + 16-bit CDF quantization (ehem_codec.py:71-97), in f32.

    round-half-even, then a cummax (a cumsum can step the rounded values
    down by one) and an index ramp make every row strictly increasing, so
    every symbol has freq >= 1; mod 2^16.  Returns int32 rows holding the
    uint16 values."""
    x = logits.float()
    x = x - x.amax(dim=-1, keepdim=True)
    e = torch.exp(x)
    pdf = e / e.sum(dim=-1, keepdim=True)
    c = torch.cumsum(pdf, dim=-1)
    c = c / c[..., -1:]
    cdf = torch.cat([torch.zeros_like(c[..., :1]), c], dim=-1)
    lp = cdf.shape[-1]
    scaled = cdf * torch.tensor(65536.0 - (lp - 1), dtype=torch.float32)
    q = torch.cummax(torch.round(scaled).to(torch.int32), dim=-1).values
    q = q + torch.arange(lp, dtype=torch.int32, device=q.device)
    return q & 0xFFFF


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _call_plan(n: int, csz: int, group: int, small: int, mesh_mult: int = 0):
    """Static per-level call layout [(row_start, lanes, width)] in chunk
    order (grouped full chunks, leftover full chunks, one bucketed partial)
    plus the padded row count — a copy of scp_tpu's _call_plan (:132)."""
    full = n // csz
    rem = n - full * csz
    # a tail past half a chunk rides the last call as one more lane
    if full and rem * 2 > csz:
        full += 1
        rem = 0
    calls = []
    s = 0
    grouped = (full // group) * group
    for _ in range(0, grouped, group):
        calls.append((s, group, csz))
        s += group * csz
    left = full - grouped
    if mesh_mult > 1:
        while left >= mesh_mult:
            take = (min(left, group) // mesh_mult) * mesh_mult
            calls.append((s, take, csz))
            s += take * csz
            left -= take
    if left:
        calls.append((s, left, csz))
        s += left * csz
    if rem:
        # partial tail in the smallest covering pow2 bucket (small..csz)
        b = small
        while b < rem:
            b *= 2
        b = min(b, csz)
        calls.append((s, 1, b))
        s += b
    return calls, s


# ---- device wavefront helpers (integer-exact) -------------------------------


def _expand_core(data, pos, occ, n_par: int, n_child: int, child_level: int, unit: int):
    """Child contexts/positions from the parent buffer + parent occupancies
    (ehem_codec.py:188).  For child slot j the parent is the number of
    parents whose inclusive child-count prefix is <= j, its octant the
    rank-th set bit of the parent's occupancy byte.  Rows past n_child
    become pad rows (occ 255, rest 0).

    data (b, 4, 3) int32, pos (b, 3) int32, occ (b,) int -> (child, cpos)."""
    b = data.shape[0]
    dev = data.device
    i = torch.arange(b, dtype=torch.int64, device=dev)
    occ_i = occ.to(torch.int64)
    b8 = ((occ_i + 1)[:, None] >> torch.arange(8, device=dev)) & 1  # (b, 8)
    cnt = torch.where(i < n_par, b8.sum(1), 0)
    cum = torch.cumsum(cnt, 0)
    parent = torch.searchsorted(cum, i, right=True).clamp(max=b - 1)
    rank = i - (cum[parent] - cnt[parent])
    pb8 = b8[parent]
    bcum = torch.cumsum(pb8, 1)
    octant = torch.argmax((bcum == (rank + 1)[:, None]).to(torch.int32), dim=1)

    pdata = data[parent].to(torch.int64)  # (b, 4, 3)
    row2 = torch.stack([pdata[:, 3, 0], pdata[:, 3, 1], occ_i[parent]], dim=1)
    row3 = torch.stack(
        [torch.full_like(i, child_level), octant + 1, torch.full_like(i, 255)], dim=1
    )
    child = torch.cat([pdata[:, 1:3], row2[:, None], row3[:, None]], dim=1)
    bits = torch.stack([(octant >> 2) & 1, (octant >> 1) & 1, octant & 1], dim=1)
    cpos = pos[parent].to(torch.int64) + bits * unit
    valid = i < n_child
    # pad rows (0, 0, 255) from scalars: a small device tensor built from a
    # host list would be a blocking copy on the wavefront's critical path
    child = torch.where(valid[:, None, None], child, 0)
    child[:, :, 2] = torch.where(valid[:, None], child[:, :, 2], 255)
    cpos = torch.where(valid[:, None], cpos, 0)
    return child.to(torch.int32), cpos.to(torch.int32)


def _expand_width(plans, b_cap: int, li: int, sizes) -> int:
    """Power-of-two work width for the expand at level li -> li+1: it
    covers every row a later consumer reads (:279)."""
    need = max(int(sizes[li]), int(plans[li + 1][1]))
    w = 512
    while w < need:
        w *= 2
    return min(w, b_cap)


def _expand_windowed(data, pos, occ, n_par, n_child, child_level, unit, w):
    """Run _expand_core on the leading w rows and write them back into the
    persistent buffers, in place (rows past w keep stale values and are
    never read)."""
    if w == data.shape[0]:
        return _expand_core(data, pos, occ, n_par, n_child, child_level, unit)
    child, cpos = _expand_core(data[:w], pos[:w], occ, n_par, n_child, child_level, unit)
    data[:w] = child
    pos[:w] = cpos
    return data, pos


def _interleave(evens, odds, b: int):
    """(e_cap,) x2 -> (b,) BFS-interleaved."""
    val = torch.stack([evens, odds], dim=-1).reshape(-1)
    if val.shape[0] >= b:
        return val[:b]
    return torch.nn.functional.pad(val, (0, b - val.shape[0]))


def _window(flat, off: int, w: int):
    """flat[off:off+w], zero-padded past the end."""
    seg = flat[off : off + w]
    if seg.shape[0] < w:
        seg = torch.nn.functional.pad(seg, (0, w - seg.shape[0]))
    return seg


def _expand_parity(data, pos, evens, odds, n_par, n_child, child_level, unit, w):
    """Expansion fed by the decoder's parity-split symbol buffers."""
    occ = _interleave(evens, odds, w)
    return _expand_windowed(data, pos, occ, n_par, n_child, child_level, unit, w)


def _expand_stream(data, pos, occ_dev, lvl_off, n_par, n_child, child_level, unit, w):
    """Expansion fed by the encoder's uploaded occupancy stream."""
    occ = _window(occ_dev, lvl_off, w)
    return _expand_windowed(data, pos, occ, n_par, n_child, child_level, unit, w)


def _expand_flat(data, pos, flat, n_par, n_child, child_level, unit, w):
    """Expansion fed by a tiny level's un-split decoded symbols."""
    occ = _window(flat, 0, w)
    return _expand_windowed(data, pos, occ, n_par, n_child, child_level, unit, w)


def _emit_parity(out, evens, odds, off: int, n: int):
    """Interleave one level's parity buffers into the BFS output stream
    (in place: entries [off, off+n) of out)."""
    out[off : off + n] = _interleave(evens, odds, 2 * evens.shape[0])[:n]
    return out


def _emit_flat(out, flat, off: int, n: int):
    out[off : off + n] = flat[:n]
    return out


class EHEMCodec:
    """EHEM wavefront codec over the port's model; `mode` is one of MODES
    (scp_tpu's SCP_CODEC_MODE)."""

    TINY_UNIFORM_MAX = 512  # rans mode: levels this small use a fixed uniform prior

    def __init__(self, model: EHEM, context_size: int = 8192, mode: str = "rans",
                 group_size: int = 16, devices=None):
        """group_size: full chunks per grouped phase call (scp_tpu's
        default, 16).  devices: the lane shards' devices (module doc);
        None codes on the model's device alone."""
        if mode not in MODES:
            raise ValueError(f"EHEM coding mode must be one of {MODES}, got {mode!r}")
        devs = [model.device] if devices is None else [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("devices: at least one device")
        if len(devs) > 1 and mode != "rans":
            raise ValueError(f"the sharded codec needs the device entropy coder (mode 'rans'), "
                             f"got mode {mode!r}")
        self.mode = mode
        self.group_size = int(group_size)
        self.devices = devs
        self.device = devs[0]
        # one replica per shard (the same weights, the same kernels on each)
        self.replicas = [model if i == 0 and model.device == d else copy.deepcopy(model).to(d)
                         for i, d in enumerate(devs)]
        self.model = self.replicas[0]
        # the devices the last sharded phase call ran on (None until one
        # ran): scp_tpu's last_rows_sharding
        self.last_devices = None
        self.context_size = context_size
        self._uni_rows = None
        self.timers = profiling.StageTimers()

    # ---- static plumbing --------------------------------------------------

    @property
    def _small_bucket(self) -> int:
        return max(32, self.context_size // 8)

    def _plan_levels(self, level_sizes):
        csz, g, small = self.context_size, self.group_size, self._small_bucket
        mm = len(self.devices) if len(self.devices) > 1 else 0
        plans = []
        for n in level_sizes:
            if n <= self.TINY_UNIFORM_MAX:
                plans.append(([], n))
            else:
                plans.append(_call_plan(n, csz, g, small, mesh_mult=mm))
        b_cap = _pow2(max(p[1] for p in plans))
        e_cap = max(rans.CHUNK, b_cap // 2)
        return plans, b_cap, e_cap

    def _root_bufs(self, b_cap: int):
        """Context/position buffers holding the level-1 root; pad rows are
        level/octant/pos 0, occupancy 255."""
        data = torch.zeros((b_cap, 4, 3), dtype=torch.int32)
        data[:, :, 2] = 255
        data[0, 3, 0] = 1
        data[0, 3, 1] = 1
        pos = torch.zeros((b_cap, 3), dtype=torch.int32)
        return data.to(self.device), pos.to(self.device)

    @staticmethod
    def _norm_params(mm, max_level: int, angular: bool):
        """(lo, scale) of the in-program position normalization."""
        if angular:
            lo, hi = int(mm[0]), int(mm[1])
            return lo, np.float32(1.0 / (hi - lo + 1e-9))
        return 0, np.float32(1.0 / float(2**max_level))

    @staticmethod
    def _clip_for(level: int, max_level: int, lidar_clip):
        if lidar_clip is not None and level == max_level:
            return int(lidar_clip)
        return 2**31 - 1

    def coding_params(self) -> str:
        """Stamp of every setting that changes the phase programs' float
        math; decode refuses a mismatch.  `attn` names the window-attention
        numerics of the kernels: weights normalized and rounded to the
        compute dtype before P.V, in every kernel (B, C and E), as the
        Pallas kernels compute them; earlier card streams, whose B/C
        kernels rounded unnormalized weights, carry no such field.  `gemm`
        names the Swin sublayers' bf16 GEMM kernels (wgmma on Hopper): a
        card stream written by the WMMA kernels before them, whose sums
        ran in another order, carries no such field and is refused.
        `devices` is the lane-shard count (scp_tpu's `mesh=`).  `knnwide`
        names the numerics of kernel D's wide arm and appears only where
        that arm builds a graph (pallas_knn with the dynamic graph, or k >
        32): a card stream of the brute-force arm before it carries no such
        field and is refused, while static-graph streams keep their stamp.
        """
        geo = self.model.geo
        knn_wide = self.model.pallas_knn and not all(
            takes_pruned_arm(c, geo.k) for c in geo.graph_widths())
        return (
            f"group={self.group_size};"
            f"tiny={self.TINY_UNIFORM_MAX};"
            f"dtype={str(self.model.dtype).replace('torch.', '')};"
            f"plan=tailmerge;"
            f"devices={len(self.devices)};"
            f"knn=exact;"
            f"staticknn={1 if self.model.static_knn else 0};"
            f"pallas_knn={1 if self.model.pallas_knn else 0};"
            + (f"knnwide={KNN_WIDE_NUMERICS};" if knn_wide else "")
            + f"pallas_attn={1 if self.model.pallas_attn else 0};"
            f"attn={ATTN_NUMERICS};"
            f"gemm={GEMM_NUMERICS};"
            f"kernels={'cuda' if self.device.type == 'cuda' else 'plain'};"
            f"backend={self.backend}"
        )

    @property
    def backend(self) -> str:
        return BACKEND if self.device.type == "cuda" else "torch-cpu"

    @property
    def ac_symbols_per_node(self) -> int:
        """Coder steps per occupancy symbol (two nibble stages when staged)."""
        return 2 if self.mode == "staged" else 1

    # ---- stream coder construction (mode-aware) ---------------------------

    def new_stream_encoder(self):
        if self.mode == "rans":
            return rans.RansEncoder(self.device)
        return ac.StreamingEncoder()

    @staticmethod
    def finish_stream(enc):
        """-> (payload bytes, bit count, n_sym for the header) of a device
        rANS encoder (EHEM's or OctAttention's) or a host coder."""
        if isinstance(enc, ac.StreamingEncoder):
            n_sym = enc.n_sym
            payload, bits = enc.finish()
            return payload, bits, n_sym
        payload = enc.finish()
        return payload, len(payload) * 8, enc.n_symbols

    def new_stream_decoder(self, payload: bytes, n_sym: int, *,
                           coding_params: str | None = None):
        """Decoder over a stream's payload, scp_tpu's `(payload, n_sym)`:
        the host coder's symbol count (coder steps) in the staged and full
        modes; the rANS decoder reads its counts from the level sizes.
        `coding_params` is the stamp the stream was written with (its
        header's); a stream stamped with other settings is refused, since
        its CDF rows would not match."""
        if coding_params is not None and coding_params != self.coding_params():
            raise ValueError(
                f"stream coded with {coding_params!r}, but this codec runs "
                f"{self.coding_params()!r}"
            )
        if self.mode == "rans":
            with profiling.span("codec.upload"):
                return rans.RansDecoder(payload, self.device)
        return ac.ArithmeticDecoder(payload, n_sym)

    def _uniform_rows(self):
        if self._uni_rows is None:
            row = logits_to_cdf(torch.zeros((1, 255), device=self.device))
            self._uni_rows = row.expand(rans.CHUNK, 256).contiguous()
        return self._uni_rows

    # ---- the shared phase programs ----------------------------------------

    @staticmethod
    def _phase1(model, data_buf, pos_buf, start, clip, lo, scale, lanes, width):
        """Slice a call's contexts from the level buffers, quantize the
        positions (normalize -> u16 -> f32), run phase 1 of `model` and
        quantize its CDF rows: (rows1 (lanes*(width+1)//2, 256), f1, f2)."""
        lw = lanes * width
        d = data_buf[start : start + lw].reshape(lanes, width, 4, 3)
        d = torch.cat([torch.clamp(d[..., :1], max=clip), d[..., 1:]], dim=-1)
        p = pos_buf[start : start + lw]
        f32 = torch.float32
        pf = (p - lo).to(f32) * torch.tensor(scale, dtype=f32)
        pu = torch.round(torch.clamp(pf, 0.0, 1.0) * torch.tensor(65535.0, dtype=f32))
        pq = pu.to(torch.int32).to(f32) * torch.tensor(np.float32(1.0 / 65535.0))
        pq = pq.reshape(lanes, width, 3)
        logits1, f1, f2 = model.decode_phase1(d, pq)
        rows1 = logits_to_cdf(logits1)
        return rows1.reshape(lanes * ((width + 1) // 2), 256), f1, f2

    @staticmethod
    def _phase2(model, f1, f2, occ):
        rows = logits_to_cdf(model.decode_phase2(f1, f2, occ.to(torch.int64), False))
        return rows.reshape(-1, 256)

    def _shards(self, lanes: int):
        """[(replica, first lane, lane count)] of a phase call: one
        contiguous lane slice per device when their number divides the
        lanes (scp_tpu's _lane_sharded), else the call on devices[0]."""
        n = len(self.replicas)
        if n > 1 and lanes > 1 and lanes % n == 0:
            per = lanes // n
            return [(m, i * per, per) for i, m in enumerate(self.replicas)]
        return [(self.model, 0, lanes)]

    def _sharded_phase1(self, data_buf, pos_buf, start, clip, lo, scale, lanes, width):
        """Phase 1 of one call of the plan, each lane slice on its device:
        (rows1 on devices[0] in lane order, [(replica, f1, f2, first lane,
        lanes)] for phase 2)."""
        with profiling.span("codec.phase1"):
            rows, parts = [], []
            shards = self._shards(lanes)
            for model, l0, nl in shards:
                s, dev = start + l0 * width, model.device
                rows1, f1, f2 = self._phase1(model, data_buf[s : s + nl * width].to(dev),
                                             pos_buf[s : s + nl * width].to(dev), 0, clip, lo,
                                             scale, nl, width)
                rows.append(rows1.to(self.device))
                parts.append((model, f1, f2, l0, nl))
            if len(shards) > 1:
                self.last_devices = tuple(str(m.device) for m, _, _ in shards)
            return (torch.cat(rows) if len(rows) > 1 else rows[0]), parts

    def _sharded_phase2(self, parts, occ):
        """Phase 2 of one call from its phase-1 slices and its group-1
        symbols occ (lanes, hw) on devices[0] -> rows2 on devices[0]."""
        with profiling.span("codec.phase2"):
            rows = [self._phase2(model, f1, f2, occ[l0 : l0 + nl].to(model.device))
                    .to(self.device) for model, f1, f2, l0, nl in parts]
            return torch.cat(rows) if len(rows) > 1 else rows[0]

    @staticmethod
    def _cat_pad(parts, n: int):
        """Concat per-call tensors into the level-flat layout, padded to a
        rANS chunk multiple."""
        flat = torch.cat(parts) if len(parts) > 1 else parts[0]
        tgt = rans.pad_to_chunk(n)
        if flat.shape[0] > tgt:
            return flat[:tgt]
        if flat.shape[0] < tgt:
            pad = torch.zeros((tgt - flat.shape[0], *flat.shape[1:]), dtype=flat.dtype,
                              device=flat.device)
            flat = torch.cat([flat, pad])
        return flat

    # ---- the staged / full phase calls (host-packed chunks) ----------------

    # Host -> device payload: the context channels (level, octant,
    # occupancy incl. the 255 pad token) fit uint8 and the positions,
    # normalized to [0, 1], are quantized to uint16.  Encoder and decoder
    # share the packing and the unpacking in the phase calls, so the
    # model's float inputs are identical on both sides.

    @staticmethod
    def _pack_data(d: np.ndarray) -> np.ndarray:
        return d.astype(np.uint8)

    @staticmethod
    def _pack_pos(p: np.ndarray) -> np.ndarray:
        return np.round(np.clip(p, 0.0, 1.0) * 65535.0).astype(np.uint16)

    def _to_dev(self, arr: np.ndarray) -> torch.Tensor:
        """Upload a host array (uint16 travels as its int16 bit pattern)."""
        if arr.dtype == np.uint16:
            arr = arr.view(np.int16)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    @staticmethod
    def _host_u16(t: torch.Tensor) -> np.ndarray:
        """Fetch int32 rows of uint16 values as a uint16 array (2 B per
        entry over the link)."""
        t16 = torch.where(t >= 32768, t - 65536, t).to(torch.int16)
        return t16.cpu().numpy().view(np.uint16)

    def _phase1_call(self, db: torch.Tensor, pb: torch.Tensor):
        """One phase-1 call on packed chunks: db (lanes, b, 4, 3) uint8,
        pb (lanes, b, 3) uint16 bits -> (CDF outputs, f1, f2).  Positions
        become f32 x (1/65535), as `_phase1` computes them."""
        d = db.to(torch.int32)
        p = (pb.to(torch.int32) & 0xFFFF).to(torch.float32)
        p = p * torch.tensor(np.float32(1.0 / 65535.0))
        logits1, f1, f2 = self.model.decode_phase1(d, p)
        if self.mode == "staged":
            return staged_cdfs(logits1), f1, f2
        return (logits_to_cdf(logits1),), f1, f2

    def _phase2_call(self, f1, f2, occ1: torch.Tensor):
        """Phase 2 from the call's features and its group-1 symbols (uint8,
        255 past the chunk) -> (hi, cond) when staged, else the rows."""
        logits2 = self.model.decode_phase2(f1, f2, occ1.to(torch.int64), False)
        if self.mode == "staged":
            return staged_cdfs(logits2)
        return logits_to_cdf(logits2)

    def _level_chunks(self, n: int):
        """Split one level of n nodes into chunk ranges [(start, m), ...]."""
        csz = self.context_size
        return [(s, min(csz, n - s)) for s in range(0, n, csz)]

    def _phase1_level(self, d: np.ndarray, pos: np.ndarray):
        """Phase 1 for every chunk of a level -> [(chunk_list, outs, f1,
        f2, bucket)] in chunk order; outs is the mode's CDF tuple.

        Every call is one of three shapes: (group, csz) for grouped full
        chunks, (1, csz) for leftover full chunks and large partials,
        (1, csz / 8) for small ones."""
        csz = self.context_size
        chunks = self._level_chunks(d.shape[0])
        full = [(s, m) for (s, m) in chunks if m == csz]
        partial = [(s, m) for (s, m) in chunks if m < csz]
        calls = []
        g = self.group_size
        with self.timers.stage("dispatch_p1"):
            n_grouped = (len(full) // g) * g
            for i in range(0, n_grouped, g):
                batch = full[i : i + g]
                db = self._pack_data(np.stack([d[s : s + m] for s, m in batch]))
                pb = self._pack_pos(np.stack([pos[s : s + m] for s, m in batch]))
                outs, f1, f2 = self._phase1_call(self._to_dev(db), self._to_dev(pb))
                calls.append((batch, outs, f1, f2, csz))
            for s, m in full[n_grouped:] + partial:
                b = self._small_bucket if m <= self._small_bucket else csz
                dp, pp = pad_rows(d[s : s + m], pos[s : s + m], b)
                outs, f1, f2 = self._phase1_call(self._to_dev(self._pack_data(dp[None])),
                                                 self._to_dev(self._pack_pos(pp[None])))
                calls.append(([(s, m)], outs, f1, f2, b))
        return calls

    @staticmethod
    def _group_syms(batch, occ, n_lanes: int, width: int, parity: int) -> np.ndarray:
        """Per-chunk group symbols packed into a (n_lanes, width) uint8
        array, padded with the 255 token."""
        out = np.full((n_lanes, width), 255, np.uint8)
        for bi, (s, m) in enumerate(batch):
            sel = occ[s : s + m][parity::2]
            out[bi, : sel.shape[0]] = sel
        return out

    @torch.no_grad()
    def warmup(self, slices: LevelSlices) -> int:
        """Run every phase shape this cloud uses once (outside a timed
        run); returns the number of distinct phase shapes.  In rans mode
        that is one encode + decode roundtrip.  Clears the timers."""
        if self.mode == "rans":
            plans, _, _ = self._plan_levels(slices.level_sizes)
            shapes = {(la, w) for calls, _ in plans for _, la, w in calls}
            stream, _, _ = self.encode_to_stream(slices)
            dec = self.new_stream_decoder(stream, slices.occ_stream.shape[0])
            self.decode(dec, slices.max_level, np.array(slices.pos_mm, np.int64),
                        angular=slices.angular, level_sizes=slices.level_sizes)
            self.timers.clear()
            return len(shapes)

        csz, g = self.context_size, self.group_size
        shapes = set()
        for n in slices.level_sizes:
            n_full = n // csz
            if n_full >= g:
                shapes.add((g, csz))
            if n_full % g:
                shapes.add((1, csz))
            rem = n % csz
            if rem:
                shapes.add((1, self._small_bucket if rem <= self._small_bucket else csz))
        for bsz, bucket in sorted(shapes):
            d = np.zeros((bsz, bucket, 4, 3), np.uint8)
            d[:, :, :, 2] = 255
            p = np.zeros((bsz, bucket, 3), np.uint16)
            outs, f1, f2 = self._phase1_call(self._to_dev(d), self._to_dev(p))
            occ = self._to_dev(np.full((bsz, (bucket + 1) // 2), 255, np.uint8))
            outs2 = self._phase2_call(f1, f2, occ)
            if self.mode == "staged":
                (hi1, cond1), (hi2, cond2) = outs, outs2
                fetch = (intervals(hi1, cond1, occ), intervals(hi2, cond2, occ[:, : bucket // 2]),
                         hi1, hi2, gather_cond_rows(cond1, torch.zeros_like(occ)),
                         gather_cond_rows(cond2, torch.zeros_like(occ[:, : bucket // 2])))
            else:
                fetch = (outs[0], outs2)
            for x in fetch:
                self._host_u16(x)
        self.timers.clear()
        return len(shapes)

    # ---- encode -----------------------------------------------------------

    @torch.no_grad()
    def encode_to_stream(self, slices: LevelSlices, lidar_clip=None):
        """Encode a sliced cloud -> (stream_bytes, bit_count, seconds)."""
        with profiling.span("codec.encode"):
            t0 = time.time()
            enc = self.new_stream_encoder()
            self.encode_into(enc, slices, lidar_clip)
            with self.timers.stage("finish_chain"):
                stream, bits, _ = self.finish_stream(enc)
            return stream, bits, time.time() - t0

    @torch.no_grad()
    def encode_into(self, enc, slices: LevelSlices, lidar_clip=None) -> float:
        """Encode one sliced (sub)tree into an open stream encoder
        (ehem_codec.py:840); the multi-level driver feeds three subtrees
        through one stream.  Returns the seconds spent.

        rans: the bytes materialize in finish_stream.  staged / full: the
        device work of every level is dispatched first (encoding has no
        sequential dependency), then the levels are fetched and coded in
        stream order.  `lidar_clip` is already in the slices' level
        channel there (split_levels)."""
        t0 = time.time()
        if self.mode == "rans":
            self._encode_rans_device(enc, slices, lidar_clip)
        elif self.mode == "staged":
            per_level = [self._encode_level_staged_dispatch(li, slices)
                         for li in range(slices.num_levels)]
            for iv_calls in per_level:
                self._emit_level_staged(iv_calls, enc)
        else:
            per_level = [self._encode_level_full_dispatch(li, slices)
                         for li in range(slices.num_levels)]
            for chunks, calls, p2_calls, occ in per_level:
                self._emit_level_full(chunks, calls, p2_calls, occ, enc)
        return time.time() - t0

    # -- staged mode --

    def _encode_level_staged_dispatch(self, li: int, slices: LevelSlices):
        d = slices.data[li]
        occ = d[:, -1, 2]
        calls = self._phase1_level(d, slices.level_pos(li))
        iv_calls = []
        with self.timers.stage("dispatch_iv"):
            for batch, (hi1, cond1), f1, f2, b in calls:
                lanes = hi1.shape[0]
                evens = self._to_dev(self._group_syms(batch, occ, lanes, (b + 1) // 2, 0))
                odds = self._to_dev(self._group_syms(batch, occ, lanes, b // 2, 1))
                iv1 = intervals(hi1, cond1, evens)
                hi2, cond2 = self._phase2_call(f1, f2, evens)
                iv_calls.append((batch, iv1, intervals(hi2, cond2, odds)))
        return iv_calls

    def _emit_level_staged(self, iv_calls, enc):
        """Fetch the intervals and feed the coder in stream order:
        evens-hi, evens-lo, odds-hi, odds-lo (chunk order within each)."""
        ev, od = {}, {}
        for batch, iv1, iv2 in iv_calls:
            with self.timers.stage("fetch_iv"):
                h1, h2 = self._host_u16(iv1), self._host_u16(iv2)
            for bi, (s, m) in enumerate(batch):
                ev[s] = h1[bi, : (m + 1) // 2]  # (ne, 2, 2)
                od[s] = h2[bi, : m // 2]
        starts = sorted(ev)
        with self.timers.stage("ac_encode"):
            enc.append_intervals(np.concatenate([ev[s][:, 0] for s in starts]))
            enc.append_intervals(np.concatenate([ev[s][:, 1] for s in starts]))
            od_list = [od[s] for s in starts if od[s].shape[0]]
            if od_list:
                enc.append_intervals(np.concatenate([o[:, 0] for o in od_list]))
                enc.append_intervals(np.concatenate([o[:, 1] for o in od_list]))

    # -- full mode --

    def _encode_level_full_dispatch(self, li: int, slices: LevelSlices):
        d = slices.data[li]
        occ = d[:, -1, 2]
        calls = self._phase1_level(d, slices.level_pos(li))
        p2_calls = []
        with self.timers.stage("dispatch_p2"):
            for batch, _outs, f1, f2, b in calls:
                evens = self._group_syms(batch, occ, f1.shape[0], (b + 1) // 2, 0)
                p2_calls.append((batch, self._phase2_call(f1, f2, self._to_dev(evens))))
        return self._level_chunks(d.shape[0]), calls, p2_calls, occ

    def _emit_level_full(self, chunks, calls, p2_calls, occ, enc):
        """Fetch one call's rows at a time; code evens, then odds, in chunk
        order."""
        rows = {}
        for batch, (cdf1,), _f1, _f2, _b in calls:
            with self.timers.stage("fetch_cdf"):
                host = self._host_u16(cdf1)
            for bi, (s, m) in enumerate(batch):
                rows[s] = host[bi, : (m + 1) // 2]
        with self.timers.stage("ac_encode"):
            for s, m in chunks:
                enc.append_quantized(rows[s], occ[s : s + m][0::2].astype(np.int16))
        rows2 = {}
        for batch, cdf2 in p2_calls:
            with self.timers.stage("fetch_cdf"):
                host = self._host_u16(cdf2)
            for bi, (s, m) in enumerate(batch):
                if m // 2:
                    rows2[s] = host[bi, : m // 2]
        with self.timers.stage("ac_encode"):
            for s, m in chunks:
                if m // 2:
                    enc.append_quantized(rows2[s], occ[s : s + m][1::2].astype(np.int16))

    # -- rans mode --

    def _encode_rans_device(self, enc, slices: LevelSlices, lidar_clip=None):
        """Device wavefront encode (ehem_codec.py:888): the occupancy byte
        stream is uploaded once; contexts and positions are rebuilt level
        by level on the device by the decoder's own expansion."""
        sizes = slices.level_sizes
        max_level = slices.max_level
        plans, b_cap, e_cap = self._plan_levels(sizes)
        total = sum(sizes)
        n_cap = _pow2(total + max(b_cap, rans.CHUNK))
        occ_host = np.zeros(n_cap, np.uint8)
        occ_host[:total] = slices.occ_stream.astype(np.uint8)
        occ_dev = torch.from_numpy(occ_host).to(self.device)
        data_buf, pos_buf = self._root_bufs(b_cap)

        off = 0
        for li, n in enumerate(sizes):
            level = li + 1
            clip = self._clip_for(level, max_level, lidar_clip)
            lo, scale = self._norm_params(
                slices.pos_mm[li] if slices.angular else (0, 0), max_level, slices.angular
            )
            if n <= self.TINY_UNIFORM_MAX:
                seg = occ_dev[off : off + rans.CHUNK].to(torch.int64)
                ar = torch.arange(rans.CHUNK, device=self.device)
                syms = torch.where(ar < n, seg, 0)
                enc.append_group(rans.gather_start_freq(self._uniform_rows(), syms), n)
            else:
                calls, _ = plans[li]
                ne, no = (n + 1) // 2, n // 2
                sf_e, sf_o = [], []
                for s, lanes, width in calls:
                    rows1, parts = self._sharded_phase1(
                        data_buf, pos_buf, s, clip, lo, scale, lanes, width
                    )
                    lw = lanes * width
                    seg = occ_dev[off + s : off + s + lw].to(torch.int64)
                    idx = off + s + torch.arange(lw, device=self.device)
                    seg = torch.where(idx < off + n, seg, 255).reshape(lanes, width)
                    evens, odds = seg[:, 0::2], seg[:, 1::2]
                    sf_e.append(rans.gather_start_freq(rows1, evens.reshape(-1)))
                    rows2 = self._sharded_phase2(parts, evens)
                    sf_o.append(rans.gather_start_freq(rows2, odds.reshape(-1)))
                enc.append_group(self._cat_pad(sf_e, ne), ne)
                if no:
                    enc.append_group(self._cat_pad(sf_o, no), no)
            if level < max_level:
                # child cell size 2^(max_level - (level+1) + 1)
                with profiling.span("codec.expand"):
                    data_buf, pos_buf = _expand_stream(
                        data_buf, pos_buf, occ_dev, off, n, sizes[li + 1], level + 1,
                        1 << (max_level - level), _expand_width(plans, b_cap, li, sizes),
                    )
            off += n

    # ---- decode -----------------------------------------------------------

    @torch.no_grad()
    def decode(self, dec, max_level: int, pos_mm, angular: bool, lidar_clip=None,
               ground_truth=None, level_sizes=None) -> np.ndarray:
        """Level-wavefront decode -> occupancies 0..254 in BFS order.
        level_sizes (from the stream header) fix every shape up front;
        `ground_truth` enables the lossless check.  The staged and full
        modes decode level by level on the host loop, which derives every
        shape from the decoded symbols (level_sizes unused)."""
        with profiling.span("codec.decode"):
            if self.mode != "rans":
                return self._decode_host_loop(dec, max_level, pos_mm, angular, lidar_clip,
                                              ground_truth)
            if level_sizes is None:
                raise ValueError("rans decode needs the header's per-level node counts")
            gen = self.decode_steps(dec, max_level, pos_mm, angular, lidar_clip,
                                    ground_truth, level_sizes)
            while True:
                try:
                    next(gen)
                except StopIteration as e:
                    return e.value

    def decode_steps(self, dec, max_level, pos_mm, angular, lidar_clip=None,
                     ground_truth=None, level_sizes=None):
        """Generator yielding after each level's dispatch (rans mode); its
        return value (StopIteration.value) is the decoded codes
        (ehem_codec.py:1124)."""
        if self.mode != "rans":
            raise ValueError(f"decode_steps steps the rans wavefront, not mode {self.mode!r}")
        sizes = [int(s) for s in level_sizes]
        if len(sizes) != max_level:
            raise ValueError(f"{len(sizes)} level sizes for {max_level} levels")
        plans, b_cap, e_cap = self._plan_levels(sizes)
        total = sum(sizes)
        n_cap = _pow2(max(total, 1)) + max(2 * e_cap, rans.CHUNK)
        out = torch.zeros(n_cap, dtype=torch.uint8, device=self.device)
        data_buf, pos_buf = self._root_bufs(b_cap)

        off = 0
        for li, n in enumerate(sizes):
            level = li + 1
            clip = self._clip_for(level, max_level, lidar_clip)
            lo, scale = self._norm_params(pos_mm[li] if angular else (0, 0), max_level,
                                          angular)
            if n <= self.TINY_UNIFORM_MAX:
                flat = dec.decode_group(self._uniform_rows(), n)
                out = _emit_flat(out, flat, off, n)
                if level < max_level:
                    with profiling.span("codec.expand"):
                        data_buf, pos_buf = _expand_flat(
                            data_buf, pos_buf, flat, n, sizes[li + 1], level + 1,
                            1 << (max_level - level), _expand_width(plans, b_cap, li, sizes),
                        )
                off += n
                yield li
                continue

            calls, _ = plans[li]
            ne, no = (n + 1) // 2, n // 2
            p1_outs = []
            for s, lanes, width in calls:
                rows1, parts = self._sharded_phase1(data_buf, pos_buf, s, clip, lo, scale,
                                                    lanes, width)
                p1_outs.append((s, lanes, width, rows1, parts))
            rows_e = self._cat_pad([o[3] for o in p1_outs], ne)
            evens_cap = _window(dec.decode_group(rows_e, ne), 0, e_cap)

            rows2 = []
            for s, lanes, width, _rows1, parts in p1_outs:
                hw = (width + 1) // 2
                seg = _window(evens_cap, s // 2, lanes * hw).to(torch.int64)
                idx = s // 2 + torch.arange(lanes * hw, device=self.device)
                occ = torch.where(idx < ne, seg, 255).reshape(lanes, hw)
                rows2.append(self._sharded_phase2(parts, occ))
            if no:
                odds_cap = _window(dec.decode_group(self._cat_pad(rows2, no), no), 0, e_cap)
            else:
                odds_cap = evens_cap

            out = _emit_parity(out, evens_cap, odds_cap, off, n)
            if level < max_level:
                with profiling.span("codec.expand"):
                    data_buf, pos_buf = _expand_parity(
                        data_buf, pos_buf, evens_cap, odds_cap, n, sizes[li + 1], level + 1,
                        1 << (max_level - level), _expand_width(plans, b_cap, li, sizes),
                    )
            off += n
            yield li

        with profiling.span("codec.fetch"):
            codes = out[:total].cpu().numpy().astype(np.int16)
        if ground_truth is not None:
            bad = np.nonzero(np.asarray(ground_truth)[:total] != codes)[0]
            if bad.size:
                i = int(bad[0])
                lvl = int(np.searchsorted(np.cumsum(sizes), i, side="right")) + 1
                raise AssertionError(
                    f"decode mismatch at node {i} (level {lvl}): "
                    f"got {int(codes[i])}, want {int(ground_truth[i])}"
                )
        return codes

    # ---- the staged / full host-loop decode ---------------------------------

    def _decode_host_loop(self, dec, max_level, pos_mm, angular, lidar_clip, ground_truth):
        """Level-wavefront decode on the host (ehem_codec.py:1057-1095):
        per level, normalize the positions, clip the deepest level's level
        channel, decode the level, expand the children on the host."""
        # root context: 3 missing-ancestor rows + self (level 1, octant 1)
        data = np.zeros((1, 4, 3), np.int32)
        data[:, :, 2] = 255
        data[0, 3] = (1, 1, 255)
        pos_int = np.zeros((1, 3), np.int64)

        codes: list[np.ndarray] = []
        decoded = 0
        for level in range(1, max_level + 1):
            n = data.shape[0]
            mm = tuple(pos_mm[level - 1]) if angular else (0, 0)
            pos = normalize_positions(pos_int, mm, max_level, angular)
            dc = data
            if lidar_clip is not None and level == max_level:
                # the deepest level's level channel only, as split_levels
                # clips it at encode
                dc = data.copy()
                dc[:, :, 0] = np.minimum(dc[:, :, 0], lidar_clip)
            if self.mode == "staged":
                level_occ = self._decode_level_staged(dec, dc, pos)
            else:
                level_occ = self._decode_level_full(dec, dc, pos)
            if ground_truth is not None:
                want = np.asarray(ground_truth)[decoded : decoded + n]
                if not (want == level_occ.astype(np.int16)).all():
                    i = int(np.nonzero(want != level_occ.astype(np.int16))[0][0])
                    raise AssertionError(
                        f"decode mismatch at node {decoded + i} (level {level}): "
                        f"got {int(level_occ[i])}, want {int(want[i])}")
            decoded += n
            codes.append(level_occ.astype(np.int16))
            if level == max_level:
                break
            with self.timers.stage("expand"):
                data, pos_int = _expand_children(data, pos_int, level_occ, level + 1, max_level)
        return np.concatenate(codes)

    @staticmethod
    def _assemble(chunks, n: int, evens_by_chunk, odds_by_chunk) -> np.ndarray:
        level_occ = np.empty(n, np.int32)
        for s, m in chunks:
            level_occ[s : s + m : 2] = evens_by_chunk[s]
            if m // 2:
                level_occ[s + 1 : s + m : 2] = odds_by_chunk[s]
        return level_occ

    def _decode_level_staged(self, dec, dc, pos) -> np.ndarray:
        """Staged decode of one level (ehem_codec.py:1247).  Per parity:
        fetch the hi rows -> coder -> upload hi and gather the conditional
        rows on the device -> fetch -> coder.  The gathers of call k are
        dispatched while the host decodes call k + 1's hi stage, and phase
        2 of call k while it decodes call k + 1's lo stage."""
        chunks = self._level_chunks(dc.shape[0])
        calls = self._phase1_level(dc, pos)

        def hi_stage(outs, count):
            """Decode each call's hi stage; dispatch its row gather."""
            staged = []
            for batch, (hi_rows, cond) in outs:
                with self.timers.stage("fetch_cdf"):
                    host = self._host_u16(hi_rows)
                hi_pad = np.zeros(host.shape[:2], np.uint8)
                his = {}
                with self.timers.stage("ac_decode"):
                    for bi, (s, m) in enumerate(batch):
                        if count(m):
                            his[s] = dec.decode_batch_quantized(
                                host[bi, : count(m)]).astype(np.int32)
                            hi_pad[bi, : count(m)] = his[s]
                with self.timers.stage("dispatch_gather"):
                    staged.append((batch, his, gather_cond_rows(cond, self._to_dev(hi_pad))))
            return staged

        def lo_stage(batch, his, rows, count, syms):
            """Decode one call's lo stage into syms; -> the call's symbols
            padded with 255."""
            with self.timers.stage("fetch_cdf"):
                host = self._host_u16(rows)
            pad = np.full(host.shape[:2], 255, np.uint8)
            with self.timers.stage("ac_decode"):
                for bi, (s, m) in enumerate(batch):
                    if count(m):
                        lo = dec.decode_batch_quantized(host[bi, : count(m)]).astype(np.int32)
                        syms[s] = his[s] * 16 + lo
                        pad[bi, : count(m)] = syms[s]
            return pad

        def n_even(m):
            return (m + 1) // 2

        def n_odd(m):
            return m // 2

        evens, p2_outs = {}, []
        staged = hi_stage([(batch, outs) for batch, outs, _f1, _f2, _b in calls], n_even)
        for (batch, his, rows), (_, _o, f1, f2, _b) in zip(staged, calls):
            occ_pad = lo_stage(batch, his, rows, n_even, evens)
            with self.timers.stage("dispatch_p2"):
                p2_outs.append((batch, self._phase2_call(f1, f2, self._to_dev(occ_pad))))
        odds = {}
        for batch, his, rows in hi_stage(p2_outs, n_odd):
            lo_stage(batch, his, rows, n_odd, odds)
        return self._assemble(chunks, dc.shape[0], evens, odds)

    def _decode_level_full(self, dec, dc, pos) -> np.ndarray:
        """Full-mode decode of one level: one 256-entry row per node."""
        chunks = self._level_chunks(dc.shape[0])
        calls = self._phase1_level(dc, pos)
        evens_by_chunk, p2_calls = {}, []
        for batch, (cdf1,), f1, f2, b in calls:
            with self.timers.stage("fetch_cdf"):
                host = self._host_u16(cdf1)
            occ = np.full((f1.shape[0], (b + 1) // 2), 255, np.uint8)
            with self.timers.stage("ac_decode"):
                for bi, (s, m) in enumerate(batch):
                    e = dec.decode_batch_quantized(host[bi, : (m + 1) // 2]).astype(np.int32)
                    evens_by_chunk[s] = e
                    occ[bi, : e.shape[0]] = e
            with self.timers.stage("dispatch_p2"):
                p2_calls.append((batch, self._phase2_call(f1, f2, self._to_dev(occ))))
        odds_by_chunk = {}
        for batch, cdf2 in p2_calls:
            with self.timers.stage("fetch_cdf"):
                host = self._host_u16(cdf2)
            with self.timers.stage("ac_decode"):
                for bi, (s, m) in enumerate(batch):
                    if m // 2:
                        odds_by_chunk[s] = dec.decode_batch_quantized(
                            host[bi, : m // 2]).astype(np.int32)
        return self._assemble(chunks, dc.shape[0], evens_by_chunk, odds_by_chunk)


def _expand_children(data, pos_int, level_occ, child_level: int, max_level: int):
    """Host wavefront expansion (ehem_codec.py:1376): (n, 4, 3) contexts +
    (n, 3) grid positions of a level and its occupancies -> the children's
    (m, 4, 3) contexts (occupancy unknown) and (m, 3) positions."""
    pidx, octant = occupancy_to_child_octants(level_occ + 1)
    m = pidx.shape[0]
    # ancestors shift up one slot; the parent's occupancy is now known
    child_data = np.empty((m, 4, 3), np.int32)
    child_data[:, 0:3] = data[pidx, 1:4]
    child_data[:, 2, 2] = level_occ[pidx]
    child_data[:, 3, 0] = child_level
    child_data[:, 3, 1] = octant + 1
    child_data[:, 3, 2] = 255
    unit = np.int64(1) << np.int64(max_level - child_level + 1)
    bits = np.stack([(octant >> 2) & 1, (octant >> 1) & 1, octant & 1], axis=1).astype(np.int64)
    return child_data, pos_int[pidx] + bits * unit


def encode_context_array(codec: EHEMCodec, ctx: np.ndarray, angular: bool,
                         lidar_clip: int | None = None):
    """Convenience: raw (N, 4, 6) shard -> (stream, bits, slices, seconds)."""
    slices = split_levels(ctx, angular=angular, lidar_level_clip=lidar_clip)
    stream, bits, elapsed = codec.encode_to_stream(slices, lidar_clip=lidar_clip)
    return stream, bits, slices, elapsed
