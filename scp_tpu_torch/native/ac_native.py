"""ctypes bindings for the native range coder (the twin of
scp_tpu/native/ac_native.py).  The library is the port's own build of
`src/ac.cpp` (native/build.py); a failed build raises NativeBuildError."""

from __future__ import annotations

import ctypes

import numpy as np

from scp_tpu_torch.native.build import BUILD_DIR, NativeBuildError, load_library

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32


def _lib(build_dir: str = BUILD_DIR) -> ctypes.CDLL:
    lib = load_library(build_dir)
    for name, restype, argtypes in (
        ("ac_encode_cdf", ctypes.POINTER(ctypes.c_uint8),
         [_P, _I64, _I32, _P, ctypes.POINTER(_I64)]),
        ("ac_free", None, [_P]),
        ("ac_decoder_new", _P, [_P, _I64, _I64]),
        ("ac_decoder_free", None, [_P]),
        ("ac_decode_batch", _I64, [_P, _P, _I64, _I32, _P]),
        ("ac_decode_batch_pdf", _I64, [_P, _P, _I64, _I32, _P]),
        ("ac_encoder_new", _P, []),
        ("ac_encoder_append", None, [_P, _P, _I64, _I32, _P]),
        ("ac_encoder_append_intervals", None, [_P, _P, _I64]),
        ("ac_encoder_append_pdf", None, [_P, _P, _I64, _I32, _P]),
        ("ac_encoder_finish", _I64, [_P, _P]),
        ("ac_encoder_free", None, [_P]),
    ):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def available(build_dir: str = BUILD_DIR) -> bool:
    """Whether the library builds (or is built) and loads."""
    try:
        _lib(build_dir)
    except (NativeBuildError, OSError):
        return False
    return True


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_P)


def _check_rows(rows: np.ndarray, syms: np.ndarray | None, top: int) -> None:
    """The C coder indexes rows by symbol: validate before passing pointers.
    `top` is the largest symbol a row of this width can code."""
    if rows.ndim != 2 or rows.shape[1] < 2:
        raise ValueError(f"rows must be (m, >= 2), got {rows.shape}")
    if syms is not None:
        if syms.shape != (rows.shape[0],):
            raise ValueError(f"{syms.shape} symbols for {rows.shape[0]} rows")
        if syms.size and (syms.min() < 0 or syms.max() > top):
            raise ValueError(f"symbols out of range [0, {top}]: [{syms.min()}, {syms.max()}]")


def encode_cdf(cdf_u16: np.ndarray, syms: np.ndarray) -> bytes:
    """Encode int16 symbols against (N, Lp) uint16 quantized CDF rows."""
    lib = _lib()
    cdf_u16 = np.ascontiguousarray(cdf_u16, dtype=np.uint16)
    syms = np.ascontiguousarray(syms, dtype=np.int16)
    _check_rows(cdf_u16, syms, cdf_u16.shape[1] - 2)
    n, lp = cdf_u16.shape
    out_len = _I64(0)
    buf = lib.ac_encode_cdf(_ptr(cdf_u16), n, lp, _ptr(syms), ctypes.byref(out_len))
    try:
        return ctypes.string_at(buf, out_len.value)
    finally:
        lib.ac_free(buf)


class NativeEncoder:
    """Streaming encoder: append (cdf_rows, syms) chunks, then finish()."""

    def __init__(self):
        self._lib = _lib()
        self._h = self._lib.ac_encoder_new()

    def append(self, cdf_u16: np.ndarray, syms: np.ndarray):
        cdf_u16 = np.ascontiguousarray(cdf_u16, dtype=np.uint16)
        syms = np.ascontiguousarray(syms, dtype=np.int16)
        _check_rows(cdf_u16, syms, cdf_u16.shape[1] - 2)
        m, lp = cdf_u16.shape
        self._lib.ac_encoder_append(self._h, _ptr(cdf_u16), m, lp, _ptr(syms))

    def append_intervals(self, iv_u16: np.ndarray):
        """Append pre-gathered (c_low, c_high) interval pairs (m, 2) u16;
        c_high == 0 means the wrapped CDF top 2^16."""
        iv_u16 = np.ascontiguousarray(iv_u16, dtype=np.uint16)
        if iv_u16.ndim != 2 or iv_u16.shape[1] != 2:
            raise ValueError(f"intervals must be (m, 2), got {iv_u16.shape}")
        self._lib.ac_encoder_append_intervals(self._h, _ptr(iv_u16), iv_u16.shape[0])

    def append_pdf(self, pdf_f32: np.ndarray, syms: np.ndarray):
        """Fused CDF quantization + encode from float32 pdf rows."""
        pdf_f32 = np.ascontiguousarray(pdf_f32, dtype=np.float32)
        syms = np.ascontiguousarray(syms, dtype=np.int16)
        _check_rows(pdf_f32, syms, pdf_f32.shape[1] - 1)
        m, L = pdf_f32.shape
        self._lib.ac_encoder_append_pdf(self._h, _ptr(pdf_f32), m, L, _ptr(syms))

    def finish(self) -> bytes:
        n = self._lib.ac_encoder_finish(self._h, None)
        buf = ctypes.create_string_buffer(n)
        self._lib.ac_encoder_finish(self._h, buf)
        return buf.raw

    def close(self):
        if self._h:
            self._lib.ac_encoder_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeDecoder:
    """Streaming decoder: one bitstream, many batched decode calls."""

    def __init__(self, stream: bytes, n_sym: int):
        self._lib = _lib()
        self._h = self._lib.ac_decoder_new(stream, len(stream), n_sym)

    def decode_batch(self, cdf_u16: np.ndarray) -> np.ndarray:
        """Decode cdf_u16.shape[0] symbols; row i gates symbol i."""
        cdf_u16 = np.ascontiguousarray(cdf_u16, dtype=np.uint16)
        _check_rows(cdf_u16, None, 0)
        m, lp = cdf_u16.shape
        out = np.empty(m, dtype=np.int16)
        got = self._lib.ac_decode_batch(self._h, _ptr(cdf_u16), m, lp, _ptr(out))
        return out[:got]

    def decode_batch_pdf(self, pdf_f32: np.ndarray) -> np.ndarray:
        """Fused CDF quantization + decode from float32 pdf rows."""
        pdf_f32 = np.ascontiguousarray(pdf_f32, dtype=np.float32)
        _check_rows(pdf_f32, None, 0)
        m, L = pdf_f32.shape
        out = np.empty(m, dtype=np.int16)
        got = self._lib.ac_decode_batch_pdf(self._h, _ptr(pdf_f32), m, L, _ptr(out))
        return out[:got]

    def close(self):
        if self._h:
            self._lib.ac_decoder_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
