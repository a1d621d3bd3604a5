"""Device rANS of the OctAttention incremental (KV-cache) schedule (port of
scp_tpu/codec/octattn_rans.py).

The incremental codec decodes all chunks of a level in lockstep, one step
per node POSITION over a lane axis (codec/octattn_codec.py).  This coder
keeps the entropy coding of that schedule on the device: the position
loop is step -> rANS decode -> cache insert with no host sync, and one
symbol fetch per level.  Same coder math as codec/rans.py (byte-wise
rANS, 16-bit frequencies), with an interleaving sized for this schedule:

  * K lanes = pow2 bucket of the cloud's largest per-level chunk count,
    stamped at the head of the payload.  Lane c carries chunk c of every
    level; lane states persist across levels and subtrees.
  * one group per level, in level order; within a level one decode step
    per node position j (ascending), lanes consumed in ascending order.
    The active-lane count at step j is ceil((n - j) / csz) for
    j < min(csz, n); both sides derive it from the same (n, csz).
  * the encoder walks levels and steps in reverse; each level's bytes are
    laid out in consume order (the sort-free scatter of rans._encode_chunk).

The payload is byte-identical to scp_tpu's for the same (rows, symbols).
Integer arithmetic only: int64 tensors carry the uint32 states exactly.

The decoder holds the stream in a buffer of a fixed size, the stream cap
(2 MiB by default, ~6M nodes at ~2.8 bits/node), and a step reads at most
2K + 2 bytes past its pointer; a payload that would not leave that much
room raises, at encode as at decode, so no read ever runs past the
buffer.  The cap is a constructor argument (scp_tpu's SCP_OCTRANS_CAP)
and is stamped in the codec's coding_params.
"""

from __future__ import annotations

import numpy as np
import torch

from scp_tpu_torch.codec import rans
from scp_tpu_torch.utils import profiling

DEFAULT_CAP = 1 << 21


def lane_bucket(n_chunks: int) -> int:
    """Pow2 lane bucket (octattn_codec's lane count)."""
    lanes = 1
    while lanes < n_chunks:
        lanes *= 2
    return lanes


def active_count(n: int, csz: int, j: int) -> int:
    """Lanes active at position j of an n-node level with chunk size csz:
    lane c is active iff c*csz + j < n."""
    if j >= min(csz, n):
        return 0
    return -(-(n - j) // csz)


def decode_step_core(states, ptr, stream, rows, n_active):
    """Decode one position across the lanes.

    states (K,) int64, ptr () int64 byte offset, stream (B,) uint8 with
    ptr + 2K + 2 <= B, rows (lanes, 256) int with lanes <= K (missing lanes
    are never active), n_active a host int or an int64 device scalar.
    Updates states and ptr in place and returns syms (K,) int64; inactive
    lanes decode 0 and keep their state."""
    k = states.shape[0]
    r = rans._row_i32(rows)
    if r.shape[0] < k:
        # padded lanes: zero rows, the identity transition, masked anyway
        r = torch.cat([r, torch.zeros((k - r.shape[0], r.shape[1]), dtype=r.dtype,
                                      device=r.device)])
    active = torch.arange(k, device=states.device) < n_active
    slot = states & 0xFFFF
    sym = (r[:, :255] <= slot[:, None]).sum(-1) - 1
    start = torch.gather(r, 1, sym[:, None])[:, 0]
    freq = torch.gather(r, 1, (sym + 1)[:, None])[:, 0] - start
    x2 = freq * (states >> 16) + slot - start
    cnt = torch.where(active, (x2 < rans.RANS_L).to(torch.int64) + (x2 < rans.HALF_L), 0)
    offs = ptr + torch.cumsum(cnt, 0) - cnt
    b0 = stream[offs].to(torch.int64)
    b1 = stream[offs + 1].to(torch.int64)
    x3 = torch.where(cnt >= 1, (x2 << 8) | b0, x2)
    x3 = torch.where(cnt == 2, (x3 << 8) | b1, x3)
    states.copy_(torch.where(active, x3, states))
    ptr.add_(cnt.sum())
    return torch.where(active, sym, 0)


def _encode_level(states, sf, n: int, csz: int):
    """Reverse-encode one level.  sf (nsteps, lanes, 2) int64 per (step,
    lane) (cdf_low, freq); nsteps may exceed min(csz, n) and lanes may be
    < K, and both paddings encode nothing.  Returns (bytes (nsteps*K*2,)
    uint8 in consume order, count () int64, states)."""
    k = states.shape[0]
    nsteps, lanes, _ = sf.shape
    dev = states.device
    lane = torch.arange(k, device=dev)
    cb0 = torch.zeros((nsteps, k), dtype=torch.int64, device=dev)
    cb1 = torch.zeros_like(cb0)
    cnt = torch.zeros_like(cb0)
    for j in reversed(range(min(csz, n, nsteps))):
        active = lane < active_count(n, csz, j)
        start = torch.zeros(k, dtype=torch.int64, device=dev)
        freq = torch.ones(k, dtype=torch.int64, device=dev)  # inactive: no division by 0
        start[:lanes] = sf[j, :, 0]
        freq[:lanes] = torch.where(active[:lanes], sf[j, :, 1], 1)
        x_max = freq << 15
        c = torch.where(active, (states >= x_max).to(torch.int64) + ((states >> 8) >= x_max), 0)
        # consume order is the reverse of push order
        cb0[j] = torch.where(c == 2, (states >> 8) & 0xFF, states & 0xFF)
        cb1[j] = states & 0xFF
        cnt[j] = c
        xr = states >> (8 * c)
        x_new = (torch.div(xr, freq, rounding_mode="floor") << 16) + xr % freq + start
        states = torch.where(active, x_new, states)
    cnt_f = cnt.reshape(-1)
    pos = torch.cumsum(cnt_f, 0) - cnt_f
    total = cnt_f.sum()
    buf = torch.zeros(2 * nsteps * k + 1, dtype=torch.int64, device=dev)
    dump = 2 * nsteps * k  # writes of absent bytes land here and are dropped
    buf[torch.where(cnt_f >= 1, pos, dump)] = cb0.reshape(-1)
    buf[torch.where(cnt_f == 2, pos + 1, dump)] = cb1.reshape(-1)
    return buf[:-1].to(torch.uint8), total, states


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _check_cap(body_bytes: int, k: int, cap: int, what: str) -> None:
    if body_bytes + 2 * k + 2 > cap:
        raise ValueError(
            f"{what} ({body_bytes} B) exceeds the stream cap ({cap} B) of the fused "
            "schedule and could not be decoded; code with a larger cap (the same on "
            "encoder and decoder)")


class OctRansEncoder:
    """Collects each level's (cdf_low, freq) device tensor during the
    teacher-forced step loop; finish() runs the reverse encode and fetches
    the payload once."""

    def __init__(self, k_lanes: int, device, cap: int = DEFAULT_CAP):
        if k_lanes != _pow2(k_lanes) or not 1 <= k_lanes <= 0xFFFF:
            raise ValueError(f"lane count {k_lanes} is not a power of two in [1, 65535]")
        self.k = k_lanes
        self.device = torch.device(device)
        self.cap = int(cap)
        self.levels: list[tuple[torch.Tensor, int, int]] = []  # (sf, n, csz)
        self.n_symbols = 0

    def append_level(self, sf: torch.Tensor, n: int, csz: int) -> None:
        """sf: (nsteps, lanes, 2) int64 on the device, position-major; n
        real symbols in the level; nsteps >= min(csz, n)."""
        if sf.shape[0] < min(csz, n) or sf.shape[1] > self.k:
            raise ValueError(f"level buffer {tuple(sf.shape)} does not cover n={n}, "
                             f"csz={csz} in {self.k} lanes")
        if n:
            self.levels.append((sf, int(n), int(csz)))
            self.n_symbols += int(n)

    def ideal_bits(self) -> float:
        """sum(-log2(freq / 2^16)) over the symbols held: the payload's
        bits less the coder's constants (the lane states and the header)."""
        total = 0.0
        for sf, n, csz in self.levels:
            cnt = torch.tensor([active_count(n, csz, j) for j in range(sf.shape[0])],
                               device=sf.device)
            live = torch.arange(sf.shape[1], device=sf.device)[None, :] < cnt[:, None]
            total += float((16.0 - torch.log2(sf[..., 1][live].double())).sum())
        return total

    def finish(self) -> bytes:
        states = torch.full((self.k,), rans.RANS_L, dtype=torch.int64, device=self.device)
        blocks = []  # reverse stream order
        for sf, n, csz in reversed(self.levels):
            block, total, states = _encode_level(states, sf, n, csz)
            blocks.append((block, total))
        blocks.reverse()
        body = b""
        if blocks:
            with profiling.span("octattn.fetch"):
                totals = torch.stack([t for _, t in blocks]).cpu().tolist()
            body = torch.cat([b[:t] for (b, _), t in zip(blocks, totals)])
            with profiling.span("octattn.fetch"):
                body = body.cpu().numpy().tobytes()
        _check_cap(len(body), self.k, self.cap, "encoded payload")
        with profiling.span("octattn.fetch"):
            head = states.cpu().numpy().astype("<u4").tobytes()
        return np.uint16(self.k).tobytes() + head + body


class OctRansDecoder:
    """Holds (states, ptr) on the device across levels and subtrees; step()
    returns device symbols with no host sync."""

    def __init__(self, payload: bytes, device, cap: int = DEFAULT_CAP):
        if len(payload) < 2:
            raise ValueError("rANS payload shorter than its lane-count header")
        k = int(np.frombuffer(payload[:2], np.uint16)[0])
        if k == 0 or k != _pow2(k) or len(payload) < 2 + 4 * k:
            raise ValueError("corrupt incremental-rANS lane header")
        self.k = k
        self.cap = int(cap)
        dev = torch.device(device)
        states = np.frombuffer(payload[2 : 2 + 4 * k], "<u4").astype(np.int64)
        self.states = torch.from_numpy(states).to(dev)
        body = np.frombuffer(payload[2 + 4 * k :], np.uint8)
        _check_cap(len(body), k, self.cap, "rANS payload")
        stream = np.zeros(self.cap, np.uint8)
        stream[: len(body)] = body
        self.stream = torch.from_numpy(stream).to(dev)
        self.ptr = torch.zeros((), dtype=torch.int64, device=dev)

    def step(self, rows: torch.Tensor, n_active: int) -> torch.Tensor:
        """rows (lanes, 256) on the device; returns (K,) int64 device
        symbols (inactive lanes 0).  The states and pointer are updated in
        place."""
        return decode_step_core(self.states, self.ptr, self.stream, rows, n_active)
