"""Host arithmetic-coding front end (the twin of scp_tpu/ac/__init__.py).

Bit-exact CDF quantization of the reference front end
(`numpyAc/numpyAc.py:80-114`): a float CDF in [0, 1] is scaled by
2^16 - (Lp - 1), rounded, cast to int16 and a +arange(Lp) ramp is added so
the quantized CDF is strictly increasing.  Encoder and decoder must use the
same conversion.

Two backends with one stream format: the native C++ range coder
(native/ac_native.py, the default) and the pure-Python coder
(ac/py_coder.py).  scp_tpu takes the native one when it builds and
otherwise the Python one; here the caller chooses (`native=`), and a
native coder whose library does not build raises.  Both give streams
byte-identical to scp_tpu's on the same quantized rows.
"""

from __future__ import annotations

import numpy as np

from scp_tpu_torch.ac.py_coder import PyDecoder, PyEncoder, py_encode
from scp_tpu_torch.native import ac_native

PRECISION = 16


def quantize_cdf(cdf_float: np.ndarray) -> np.ndarray:
    """Float CDF rows (..., Lp) in [0, 1] -> strictly increasing uint16.

    Wraps modulo 2^16 like the reference's int16 cast + ramp
    (`numpyAc.py:96-107`); only the final entry (cdf == 1.0 at index Lp-1)
    can wrap, and neither encoder nor decoder ever reads it.  Scales in
    float64 whatever the input precision, as the reference front end does
    (its hstack with a float64 zero column upcasts the float32 CDF).
    """
    lp = cdf_float.shape[-1]
    scaled = cdf_float.astype(np.float64) * (2**PRECISION - (lp - 1))
    q = np.round(scaled).astype(np.int64) + np.arange(lp, dtype=np.int64)
    return (q & 0xFFFF).astype(np.uint16)


def pdf_to_cdf(pdf: np.ndarray) -> np.ndarray:
    """PDF rows (N, L) -> normalized CDF rows (N, L+1) with a leading zero,
    in the input dtype (float32 on the hot path)."""
    c = np.cumsum(pdf, axis=-1)
    c = c / c[..., -1:]
    zeros = np.zeros((*c.shape[:-1], 1), dtype=c.dtype)
    return np.concatenate([zeros, c], axis=-1)


def pdf_to_quantized_cdf(pdf: np.ndarray) -> np.ndarray:
    return quantize_cdf(pdf_to_cdf(pdf))


def check_pdf(pdf: np.ndarray, syms: np.ndarray) -> None:
    """Input validation (reference `numpyAc.py:32-39`)."""
    if pdf.min() < 0:
        raise ValueError(f"pdf.min()={pdf.min()} < 0")
    if syms.min() < 0 or syms.max() >= pdf.shape[-1]:
        raise ValueError(
            f"symbols out of range [0, {pdf.shape[-1] - 1}]: [{syms.min()}, {syms.max()}]"
        )


def encode_quantized(cdf_u16: np.ndarray, syms: np.ndarray, native: bool = True) -> bytes:
    if native:
        return ac_native.encode_cdf(cdf_u16, syms)
    return py_encode(cdf_u16, syms)


class ArithmeticEncoder:
    """Encode int symbols against per-symbol PDFs; whole-stream API."""

    def __init__(self, native: bool = True):
        self.native = native

    def encode(self, pdf: np.ndarray, syms: np.ndarray,
               binfile: str | None = None) -> tuple[bytes, int]:
        """Returns (byte_stream, bit_count); pdf (N, L), syms (N,)."""
        pdf = np.asarray(pdf)
        syms = np.asarray(syms, dtype=np.int16)
        if not (pdf.ndim == 2 and syms.ndim == 1 and pdf.shape[0] == syms.shape[0]):
            raise ValueError(f"pdf {pdf.shape} and symbols {syms.shape} do not pair up")
        check_pdf(pdf, syms)
        stream = encode_quantized(pdf_to_quantized_cdf(pdf), syms, self.native)
        if binfile is not None:
            with open(binfile, "wb") as f:
                f.write(stream)
        return stream, len(stream) * 8


class StreamingEncoder:
    """Chunk-wise encoder: per-chunk PDFs (or quantized rows) are fed as
    they are produced, so the host never holds a whole-cloud table."""

    def __init__(self, native: bool = True):
        self.native = native
        self._enc = ac_native.NativeEncoder() if native else PyEncoder()
        self.n_sym = 0

    def append(self, pdf: np.ndarray, syms: np.ndarray):
        syms = np.asarray(syms, dtype=np.int16)
        if syms.size == 0:
            return
        pdf = np.asarray(pdf)
        check_pdf(pdf, syms)
        self.n_sym += syms.shape[0]
        if self.native and pdf.dtype == np.float32:
            # fused native quantization, bit-identical to the numpy quantizer
            self._enc.append_pdf(pdf, syms)
        else:
            self._enc.append(pdf_to_quantized_cdf(pdf), syms)

    def append_quantized(self, cdf_u16: np.ndarray, syms: np.ndarray):
        """Feed already-quantized uint16 CDF rows (e.g. made on the device)."""
        syms = np.asarray(syms, dtype=np.int16)
        if syms.size == 0:
            return
        self.n_sym += syms.shape[0]
        self._enc.append(np.ascontiguousarray(cdf_u16, dtype=np.uint16), syms)

    def append_intervals(self, iv_u16: np.ndarray):
        """Feed pre-gathered (c_low, c_high) u16 interval pairs (m, 2), one
        coding step per row; c_high == 0 means the wrapped top 2^16."""
        iv_u16 = np.ascontiguousarray(iv_u16, dtype=np.uint16).reshape(-1, 2)
        if iv_u16.shape[0] == 0:
            return
        self.n_sym += iv_u16.shape[0]
        self._enc.append_intervals(iv_u16)

    def finish(self, binfile: str | None = None) -> tuple[bytes, int]:
        stream = self._enc.finish()
        if binfile is not None:
            with open(binfile, "wb") as f:
                f.write(stream)
        return stream, len(stream) * 8


class ArithmeticDecoder:
    """Streaming decoder over one bitstream, with batched decode."""

    def __init__(self, stream: bytes | None, n_sym: int, binfile: str | None = None,
                 native: bool = True):
        if binfile is not None:
            with open(binfile, "rb") as f:
                stream = f.read()
        self.n_sym = n_sym
        self.native = native
        self._dec = ac_native.NativeDecoder(stream, n_sym) if native else PyDecoder(stream, n_sym)

    def decode_batch(self, pdf: np.ndarray) -> np.ndarray:
        """Decode pdf.shape[0] symbols; row i of the (M, L) pdf gates
        symbol i.  The pdf dtype is kept: encoder and decoder must quantize
        the CDFs through the same float path or the coder desyncs."""
        pdf = np.asarray(pdf)
        if self.native and pdf.dtype == np.float32:
            return self._dec.decode_batch_pdf(pdf).astype(np.int64)
        return self._dec.decode_batch(pdf_to_quantized_cdf(pdf)).astype(np.int64)

    def decode_batch_quantized(self, cdf_u16: np.ndarray) -> np.ndarray:
        """Decode against already-quantized uint16 CDF rows."""
        return self._dec.decode_batch(
            np.ascontiguousarray(cdf_u16, dtype=np.uint16)).astype(np.int64)

    def decode_one(self, pdf_row: np.ndarray) -> int:
        return int(self.decode_batch(pdf_row.reshape(1, -1))[0])
