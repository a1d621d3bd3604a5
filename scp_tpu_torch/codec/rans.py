"""Device-side interleaved rANS entropy coder (port of scp_tpu/codec/rans.py).

The quantized CDF rows never leave the device: the encoder gathers
per-symbol (cdf_low, freq) there and fetches only the compressed bytes;
the decoder keeps its lane states on the device.

Coder math (standard rANS, byte-wise):
  state x in [L, 256*L) with L = 2^23; 16-bit quantized frequencies.
  decode:  slot = x & 0xFFFF; sym s.t. cdf[s] <= slot < cdf[s+1]
           x <- freq * (x >> 16) + slot - cdf[s]
           while x < L: x <- (x << 8) | next_byte   (<= 2 bytes)
  encode (reverse symbol order):
           while x >= freq << 15: emit x & 0xFF; x >>= 8  (<= 2 bytes)
           x <- (x // freq) << 16 | (x % freq + cdf[s])

Interleaving contract (identical to scp_tpu, so the bytes are too):
  * a stream is a sequence of GROUPS; symbol i of a group belongs to lane
    i % K, decoded at step i // K;
  * within a decode step lanes consume bytes in ascending lane order, a
    lane's 2 renorm bytes in consumption order, so offsets are an
    exclusive cumsum of per-lane byte counts;
  * the encoder walks groups, steps and lanes in reverse, and lays each
    chunk's bytes out directly in decode order;
  * lane states persist across groups; the encoder's final states head
    the payload as K little-endian u32 (only the used prefix).

States stay below 2^31 and every intermediate below 2^40, so int64
tensors carry the uint32 arithmetic exactly.  CDF rows are int32 tensors
holding the uint16 values (top entry 65536 stored wrapped as 0).

A coder on the CPU runs the plain step loops below (`_decode_chunk`,
`_encode_chunk`, the twins of scp_tpu's lax.scans).  A coder on a CUDA
device runs the hand-written kernels of `ops/csrc/rans.cu` instead, or
raises: one launch per `decode_group` (every chunk of the group) and one
per `finish` (every group of the stream), with the same bytes, symbols and
(states, ptr).
"""

from __future__ import annotations

import numpy as np
import torch

from scp_tpu_torch.utils import profiling

RANS_L = 1 << 23
HALF_L = 1 << 15  # L >> 8
K_LANES = 1024
CHUNK_STEPS = 64
CHUNK = K_LANES * CHUNK_STEPS  # symbols per chunk


def _row_i32(rows: torch.Tensor) -> torch.Tensor:
    """(..., 256) rows -> int64 with the wrapped top entry restored."""
    r = rows.to(torch.int64).clone()
    r[..., -1] = 1 << 16
    return r


def gather_start_freq(rows: torch.Tensor, syms: torch.Tensor) -> torch.Tensor:
    """Per-symbol (cdf_low, freq) from CDF rows: rows (..., 256),
    syms (...) int -> (..., 2) int64.  Real symbols are <= 254, so sym+1
    <= 255; the pad token 255 is clamped (its lane is never coded)."""
    r = _row_i32(rows)
    s = syms.to(torch.int64).clamp(0, 254)[..., None]
    lo = torch.gather(r, -1, s)[..., 0]
    hi = torch.gather(r, -1, s + 1)[..., 0]
    return torch.stack([lo, hi - lo], dim=-1)


def _chunk_steps(base: int, n: int) -> int:
    """Coder steps of the chunk starting at symbol `base` of an n-symbol group."""
    return min(CHUNK_STEPS, -(-(n - base) // K_LANES))


def _decode_chunk(states, ptr, stream, rows, base: int, n: int):
    """Decode one (CHUNK_STEPS, K_LANES) block.  states (K,) int64, ptr ()
    int64 byte offset, stream (B,) uint8, rows (CHUNK_STEPS, K, 256).
    Returns (syms (CHUNK_STEPS, K) uint8, states, ptr)."""
    dev = states.device
    lane = torch.arange(K_LANES, device=dev)
    r_all = _row_i32(rows)
    out = []
    limit = stream.shape[0] - 1
    for t in range(CHUNK_STEPS):
        if base + t * K_LANES >= n:
            out.append(torch.zeros(K_LANES, dtype=torch.uint8, device=dev))
            continue
        active = base + t * K_LANES + lane < n
        r = r_all[t]  # (K, 256)
        slot = states & 0xFFFF
        sym = (r[:, :255] <= slot[:, None]).sum(-1) - 1
        start = torch.gather(r, 1, sym[:, None])[:, 0]
        freq = torch.gather(r, 1, (sym + 1)[:, None])[:, 0] - start
        x2 = freq * (states >> 16) + slot - start
        cnt = torch.where(active, (x2 < RANS_L).to(torch.int64) + (x2 < HALF_L), 0)
        offs = ptr + torch.cumsum(cnt, 0) - cnt
        b0 = stream[offs.clamp(max=limit)].to(torch.int64)
        b1 = stream[(offs + 1).clamp(max=limit)].to(torch.int64)
        x3 = torch.where(cnt >= 1, (x2 << 8) | b0, x2)
        x3 = torch.where(cnt == 2, (x3 << 8) | b1, x3)
        states = torch.where(active, x3, states)
        ptr = ptr + cnt.sum()
        out.append(torch.where(active, sym, 0).to(torch.uint8))
    return torch.stack(out), states, ptr


def _encode_chunk(states, sf, base: int, n: int):
    """Reverse-encode one chunk.  sf (CHUNK, 2) int64 (cdf_low, freq).
    Returns (bytes (2*CHUNK,) uint8 in decode order, count () int64, states)."""
    dev = states.device
    lane = torch.arange(K_LANES, device=dev)
    sfr = sf.reshape(CHUNK_STEPS, K_LANES, 2)
    cb0 = torch.zeros((CHUNK_STEPS, K_LANES), dtype=torch.int64, device=dev)
    cb1 = torch.zeros_like(cb0)
    cnt = torch.zeros_like(cb0)
    for t in reversed(range(CHUNK_STEPS)):
        if base + t * K_LANES >= n:
            continue
        active = base + t * K_LANES + lane < n
        start = sfr[t, :, 0]
        freq = torch.where(active, sfr[t, :, 1], 1)  # inactive lanes: no division by 0
        x_max = freq << 15
        c = torch.where(
            active, (states >= x_max).to(torch.int64) + ((states >> 8) >= x_max), 0
        )
        e0 = states & 0xFF
        e1 = (states >> 8) & 0xFF
        xr = states >> (8 * c)
        # consume order is the reverse of push order (stack semantics)
        cb0[t] = torch.where(c == 2, e1, e0)
        cb1[t] = e0
        cnt[t] = c
        x_new = (torch.div(xr, freq, rounding_mode="floor") << 16) + xr % freq + start
        states = torch.where(active, x_new, states)
    cnt_f = cnt.reshape(-1)
    pos = torch.cumsum(cnt_f, 0) - cnt_f
    total = cnt_f.sum()
    buf = torch.zeros(2 * CHUNK + 1, dtype=torch.int64, device=dev)
    dump = 2 * CHUNK  # invalid writes land here and are dropped
    buf[torch.where(cnt_f >= 1, pos, dump)] = cb0.reshape(-1)
    buf[torch.where(cnt_f == 2, pos + 1, dump)] = cb1.reshape(-1)
    return buf[:-1].to(torch.uint8), total, states


def decode_group_kernel(states, ptr, stream, rows, n: int) -> torch.Tensor:
    """Kernel decode of one group: rows (n_pad, 256) int32, n_pad a CHUNK
    multiple -> (n_pad,) uint8 symbols (0 past n).  states (K,) and ptr ()
    int64 are updated in place, on the device."""
    from scp_tpu_torch.ops import _cuda

    n_pad = rows.shape[0]
    _cuda.check_cuda_tensor("rows", rows, torch.int32, (n_pad, 256))
    _cuda.check_cuda_tensor("states", states, torch.int64, (K_LANES,))
    _cuda.check_cuda_tensor("ptr", ptr, torch.int64, ())
    _cuda.check_cuda_tensor("stream", stream, torch.uint8, (stream.shape[0],))
    if not 0 <= n <= n_pad or n_pad % CHUNK:
        raise ValueError(f"rans decode kernel: {n} symbols in {n_pad} rows")
    out = torch.empty(n_pad, dtype=torch.uint8, device=rows.device)
    lib = _cuda.load("rans.cu")
    with _cuda.on_device(rows, states, ptr, stream):
        code = lib.scp_rans_decode_group(
            rows.data_ptr(), n, n_pad, stream.data_ptr(), stream.shape[0], states.data_ptr(),
            ptr.data_ptr(), out.data_ptr(), _cuda.stream_ptr(rows),
        )
    _cuda.check(lib, code, "rans decode")
    decode_group_kernel.launches += 1
    profiling.count("rans.launches", 1)
    return out


def encode_kernel(groups, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel encode of a whole stream: groups [(sf (n_pad, 2) int64, n)] in
    stream order -> (info (K+1,) int64: the body's byte count, then each
    lane's final state; buf (cap,) uint8 whose last info[0] bytes are the
    body)."""
    from scp_tpu_torch.ops import _cuda

    for sf, n in groups:
        _cuda.check_cuda_tensor("sf", sf, torch.int64, (sf.shape[0], 2))
        if n > sf.shape[0]:
            raise ValueError(f"rans encode kernel: {n} symbols in {sf.shape[0]} rows")
    # pinned, so the upload does not wait for the work queued before it
    table = torch.tensor([[sf.data_ptr(), n] for sf, n in groups],
                         dtype=torch.int64).pin_memory().to(device, non_blocking=True)
    cap = 2 * K_LANES * sum(-(-n // K_LANES) for _, n in groups)
    buf = torch.empty(cap, dtype=torch.uint8, device=device)
    info = torch.empty(K_LANES + 1, dtype=torch.int64, device=device)
    lib = _cuda.load("rans.cu")
    with _cuda.on_device(table, buf, info, *(sf for sf, _ in groups)):
        code = lib.scp_rans_encode(table.data_ptr(), len(groups), buf.data_ptr(), cap,
                                   info.data_ptr(), _cuda.stream_ptr(info))
    _cuda.check(lib, code, "rans encode")
    encode_kernel.launches += 1
    profiling.count("rans.launches", 1)
    return info, buf


decode_group_kernel.launches = 0
encode_kernel.launches = 0


class RansEncoder:
    """Collects per-group (cdf_low, freq) device tensors during the forward
    model pass; `finish()` runs the reverse-order encode chain and fetches
    the payload."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.groups: list[tuple[torch.Tensor, int]] = []
        self.n_symbols = 0

    def append_group(self, sf: torch.Tensor, n: int) -> None:
        """sf: (n_pad, 2) int64 with n_pad a CHUNK multiple; n real symbols."""
        if sf.shape[0] % CHUNK:
            raise ValueError(f"group of {sf.shape[0]} rows is not a CHUNK multiple")
        if n:
            self.groups.append((sf, int(n)))
            self.n_symbols += int(n)

    def finish(self) -> bytes:
        # lanes beyond the largest group were never touched: store only the
        # used prefix
        used = min(max((n for _, n in self.groups), default=0), K_LANES)
        finish = self._finish_plain if self.device.type == "cpu" else self._finish_kernel
        head, body = finish(used)
        return np.uint16(used).tobytes() + head + body

    def _finish_kernel(self, used: int) -> tuple[bytes, bytes]:
        if not self.groups:
            return b"", b""
        with profiling.span("rans.encode"):
            info, buf = encode_kernel(self.groups, self.device)
            profiling.count("rans.steps", sum(-(-n // K_LANES) for _, n in self.groups))
        with profiling.span("codec.fetch"):
            info = info[: used + 1].cpu().numpy()
        total = int(info[0])
        with profiling.span("codec.fetch"):
            body = buf[buf.shape[0] - total :].cpu().numpy().tobytes()
        return info[1:].astype("<u4").tobytes(), body

    def _finish_plain(self, used: int) -> tuple[bytes, bytes]:
        states = torch.full((K_LANES,), RANS_L, dtype=torch.int64, device=self.device)
        rev_blocks = []  # (block, total) in reverse stream order
        with profiling.span("rans.encode"):
            for sf, n in reversed(self.groups):
                for c in reversed(range(-(-n // CHUNK))):
                    block, total, states = _encode_chunk(
                        states, sf[c * CHUNK : (c + 1) * CHUNK], c * CHUNK, n
                    )
                    rev_blocks.append((block, total))
                    profiling.count("rans.steps", _chunk_steps(c * CHUNK, n))
        with profiling.span("codec.fetch"):
            head = states[:used].cpu().numpy().astype("<u4").tobytes()
        body = b""
        if rev_blocks:
            blocks = list(reversed(rev_blocks))
            with profiling.span("codec.fetch"):
                totals = torch.stack([t for _, t in blocks]).cpu().tolist()
            parts = torch.cat([b[:t] for (b, _), t in zip(blocks, totals)])
            with profiling.span("codec.fetch"):
                body = parts.cpu().numpy().tobytes()
        return head, body


class RansDecoder:
    """Holds (states, ptr) on the device across groups; the stream is
    uploaded once.  decode_group returns device symbols, so phase 2 and the
    interleaving never round-trip through the host."""

    def __init__(self, payload: bytes, device):
        if len(payload) < 2:
            raise ValueError("rANS payload shorter than lane-state header")
        used = int(np.frombuffer(payload[:2], np.uint16)[0])
        if used > K_LANES or len(payload) < 2 + 4 * used:
            raise ValueError("corrupt rANS lane-state header")
        states = np.full(K_LANES, RANS_L, np.int64)
        states[:used] = np.frombuffer(payload[2 : 2 + 4 * used], "<u4")
        dev = torch.device(device)
        self.states = torch.from_numpy(states).to(dev)
        body = np.frombuffer(payload[2 + 4 * used :], np.uint8)
        # headroom: a step reads up to 2*K_LANES + 2 bytes past ptr
        pad = np.zeros(2 * K_LANES + 2, np.uint8)
        self.stream = torch.from_numpy(np.concatenate([body, pad])).to(dev)
        self.ptr = torch.zeros((), dtype=torch.int64, device=dev)

    def decode_group(self, rows: torch.Tensor, n: int) -> torch.Tensor:
        """rows: (n_pad, 256) device CDF rows, n_pad a CHUNK multiple.
        Returns (n_pad,) uint8 device symbols (valid through n)."""
        if rows.shape[0] % CHUNK:
            raise ValueError(f"group of {rows.shape[0]} rows is not a CHUNK multiple")
        with profiling.span("rans.decode"):
            if self.states.device.type == "cpu":
                return self._decode_group_plain(rows, n)
            out = decode_group_kernel(self.states, self.ptr, self.stream, rows, n)
            profiling.count("rans.steps", -(-n // K_LANES))
            return out

    def _decode_group_plain(self, rows: torch.Tensor, n: int) -> torch.Tensor:
        outs = []
        for c in range(-(-n // CHUNK)):
            rows_c = rows[c * CHUNK : (c + 1) * CHUNK].reshape(CHUNK_STEPS, K_LANES, 256)
            syms, self.states, self.ptr = _decode_chunk(
                self.states, self.ptr, self.stream, rows_c, c * CHUNK, n
            )
            outs.append(syms.reshape(-1))
            profiling.count("rans.steps", _chunk_steps(c * CHUNK, n))
        got = len(outs) * CHUNK
        if got < rows.shape[0]:
            outs.append(torch.zeros(rows.shape[0] - got, dtype=torch.uint8, device=rows.device))
        return torch.cat(outs) if len(outs) > 1 else outs[0]


def pad_to_chunk(n: int) -> int:
    return -(-max(n, 1) // CHUNK) * CHUNK
