"""Pure-Python range coder (the twin of scp_tpu/ac/py_coder.py): the
coder a caller gets with `native=False`, and the test oracle of the native
one.

Same stream format as the native coder (scp_tpu_torch/native/src/ac.cpp).
Slow: for tests and small streams.
"""

from __future__ import annotations

import numpy as np

_TOP = 0x80000000
_Q1 = 0x40000000
_Q3 = 0xC0000000
_MASK32 = 0xFFFFFFFF
_SCALE = 1 << 16


class _BitWriter:
    def __init__(self):
        self.bytes = bytearray()
        self.acc = 0
        self.n = 0

    def push(self, bit: int):
        self.acc = ((self.acc << 1) | bit) & 0xFF
        self.n += 1
        if self.n == 8:
            self.bytes.append(self.acc)
            self.acc = 0
            self.n = 0

    def push_pending(self, bit: int, pending: int) -> int:
        self.push(bit)
        for _ in range(pending):
            self.push(1 - bit)
        return 0

    def pad(self):
        while self.n:
            self.push(0)


class PyEncoder:
    """Stateful streaming encoder (mirror of the native Encoder struct)."""

    def __init__(self):
        self.low, self.high, self.pending = 0, _MASK32, 0
        self.w = _BitWriter()
        self._finished = None

    def encode_interval(self, c_low: int, c_high: int):
        """One coding step from a pre-gathered (c_low, c_high) interval;
        c_high == 0 means the wrapped CDF top 2^16."""
        if c_high == 0:
            c_high = _SCALE
        span = self.high - self.low + 1
        self.high = ((self.low - 1) + ((span * c_high) >> 16)) & _MASK32
        self.low = (self.low + ((span * c_low) >> 16)) & _MASK32
        low, high, pending, w = self.low, self.high, self.pending, self.w
        while True:
            if high < _TOP:
                pending = w.push_pending(0, pending)
            elif low >= _TOP:
                pending = w.push_pending(1, pending)
            elif low >= _Q1 and high < _Q3:
                pending += 1
                low = (low << 1) & 0x7FFFFFFF
                high = ((high << 1) | 0x80000001) & _MASK32
                continue
            else:
                break
            low = (low << 1) & _MASK32
            high = ((high << 1) | 1) & _MASK32
        self.low, self.high, self.pending = low, high, pending

    def append(self, cdf_u16: np.ndarray, syms: np.ndarray):
        cdf = np.asarray(cdf_u16, dtype=np.uint64)
        syms = np.asarray(syms, dtype=np.int64)
        n, lp = cdf.shape
        for i in range(n):
            s = int(syms[i])
            c_low = int(cdf[i, s])
            c_high = _SCALE if s == lp - 2 else int(cdf[i, s + 1])
            self.encode_interval(c_low, c_high)

    def append_intervals(self, iv_u16: np.ndarray):
        iv = np.asarray(iv_u16, dtype=np.uint64).reshape(-1, 2)
        for c_low, c_high in iv:
            self.encode_interval(int(c_low), int(c_high))

    def finish(self) -> bytes:
        if self._finished is None:
            self.pending += 1
            self.w.push_pending(0 if self.low < _Q1 else 1, self.pending)
            self.w.pad()
            self._finished = bytes(self.w.bytes)
        return self._finished


def py_encode(cdf_u16: np.ndarray, syms: np.ndarray) -> bytes:
    enc = PyEncoder()
    enc.append(cdf_u16, syms)
    return enc.finish()


class PyDecoder:
    def __init__(self, stream: bytes, n_sym: int):
        self.stream = stream
        self.n_sym = n_sym
        self.decoded = 0
        self.low, self.high = 0, _MASK32
        self.pos = 0
        self.value = 0
        for _ in range(32):
            self._shift()

    def _shift(self):
        self.value = (self.value << 1) & _MASK32
        if self.pos < len(self.stream) * 8:
            byte = self.stream[self.pos >> 3]
            self.value |= (byte >> (7 - (self.pos & 7))) & 1
            self.pos += 1

    def decode_batch(self, cdf_u16: np.ndarray) -> np.ndarray:
        cdf = np.asarray(cdf_u16, dtype=np.uint64)
        m, lp = cdf.shape
        out = np.empty(m, dtype=np.int16)
        cnt = 0
        for i in range(m):
            if self.decoded >= self.n_sym:
                break
            out[i] = self._decode_one(cdf[i], lp)
            cnt += 1
        return out[:cnt]

    def _decode_one(self, row: np.ndarray, lp: int) -> int:
        span = self.high - self.low + 1
        target = ((self.value - self.low + 1) * _SCALE - 1) // span
        # largest s in [0, lp-2] with row[s] <= target; the final entry
        # row[lp-1] may have wrapped to 0 and must not be probed.
        s = int(np.searchsorted(row[: lp - 1], target, side="right")) - 1
        s = min(max(s, 0), lp - 2)
        self.decoded += 1
        if self.decoded >= self.n_sym:
            return s
        c_low = int(row[s])
        c_high = _SCALE if s == lp - 2 else int(row[s + 1])
        self.high = ((self.low - 1) + ((span * c_high) >> 16)) & _MASK32
        self.low = (self.low + ((span * c_low) >> 16)) & _MASK32
        while True:
            if self.low >= _TOP or self.high < _TOP:
                self.low = (self.low << 1) & _MASK32
                self.high = ((self.high << 1) | 1) & _MASK32
                self._shift()
            elif self.low >= _Q1 and self.high < _Q3:
                self.low = (self.low << 1) & 0x7FFFFFFF
                self.high = ((self.high << 1) | 0x80000001) & _MASK32
                self.value -= _Q1
                self._shift()
            else:
                break
        return s
