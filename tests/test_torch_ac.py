"""The port's host arithmetic coder (scp_tpu_torch.ac, its Python coder
and the native coder it builds from scp_tpu_torch/native/src/ac.cpp)
against scp_tpu.ac on the CPU: on the same quantized rows both of the
port's backends write streams byte-identical to scp_tpu's, through every
entry point (whole-stream, streaming from pdfs, from quantized rows, from
intervals), and decode them back in batches of any size.  scp_tpu's side
is pinned to its Python coder (SCP_TPU_NO_NATIVE=1): its native build
shares one <so>.tmp across test workers."""

import numpy as np
import pytest
import torch

from scp_tpu import ac as jac
from scp_tpu_torch import ac as tac
from scp_tpu_torch.native import ac_native, build


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these tests run thousands of small torch ops,
    which crawl when every test worker's thread pool spans all the cores
    (the suite runs several workers on one machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def jax_py_coder():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCP_TPU_NO_NATIVE", "1")
        yield


def random_pdfs(rng, n, L, concentration=0.5):
    p = rng.gamma(concentration, size=(n, L)) + 1e-9
    return (p / p.sum(axis=1, keepdims=True)).astype(np.float32)


def sample_syms(rng, pdfs):
    c = np.cumsum(pdfs.astype(np.float64), axis=1)
    u = rng.random((pdfs.shape[0], 1)) * c[:, -1:]
    return np.minimum((c < u).sum(1), pdfs.shape[1] - 1).astype(np.int16)


@pytest.mark.parametrize("L", [4, 255])
def test_streams_equal_jax(L):
    rng = np.random.default_rng(L)
    pdfs = random_pdfs(rng, 600, L)
    syms = sample_syms(rng, pdfs)
    cdf = tac.pdf_to_quantized_cdf(pdfs)
    np.testing.assert_array_equal(cdf, jac.pdf_to_quantized_cdf(pdfs))
    want, want_bits = jac.ArithmeticEncoder().encode(pdfs, syms)
    for native in (True, False):
        got, bits = tac.ArithmeticEncoder(native=native).encode(pdfs, syms)
        assert got == want and bits == want_bits
        assert tac.encode_quantized(cdf, syms, native=native) == want
        # streaming: pdf chunks (the native coder's fused quantizer), then
        # quantized rows, then intervals, in one stream
        jenc, tenc = jac.StreamingEncoder(), tac.StreamingEncoder(native=native)
        iv = np.stack([cdf[np.arange(600), syms],
                       np.where(syms == L - 1, 0, cdf[np.arange(600), np.minimum(syms + 1, L)])],
                      axis=1)
        for enc in (jenc, tenc):
            enc.append(pdfs[:200], syms[:200])
            enc.append_quantized(cdf[200:400], syms[200:400])
            enc.append_intervals(iv[400:])
        assert tenc.n_sym == jenc.n_sym == 600
        assert tenc.finish() == jenc.finish()
        for batch in (1, 7, 600):
            dec = tac.ArithmeticDecoder(want, len(syms), native=native)
            out = np.concatenate([dec.decode_batch_quantized(cdf[i : i + batch])
                                  for i in range(0, 600, batch)])
            np.testing.assert_array_equal(out, syms)
        dec = tac.ArithmeticDecoder(want, len(syms), native=native)
        np.testing.assert_array_equal(dec.decode_batch(pdfs), syms)


def test_native_quantizer_and_budget():
    """The native fused quantizer equals numpy's on f32 rows; decode stops
    at the stream's symbol budget."""
    rng = np.random.default_rng(5)
    pdfs = random_pdfs(rng, 300, 255, concentration=0.05)
    syms = sample_syms(rng, pdfs)
    enc = tac.StreamingEncoder(native=True)
    enc.append(pdfs, syms)
    stream, _ = enc.finish()
    assert stream == tac.encode_quantized(tac.pdf_to_quantized_cdf(pdfs), syms, native=False)
    dec = tac.ArithmeticDecoder(stream, 100, native=True)
    assert dec.decode_batch(pdfs).shape == (100,)
    with pytest.raises(ValueError):
        tac.ArithmeticEncoder().encode(-pdfs, syms)
    with pytest.raises(ValueError):
        tac.ArithmeticEncoder().encode(pdfs, syms + 300)
    cdf = tac.pdf_to_quantized_cdf(pdfs)
    for bad in (syms[:-1], np.full_like(syms, 255)):  # the C coder indexes rows by symbol
        with pytest.raises(ValueError):
            tac.StreamingEncoder(native=True).append_quantized(cdf, bad)


def test_native_build_raises_and_builds_apart(tmp_path, monkeypatch):
    """The library builds into its own directory (per-process temp file,
    then rename); a failed build raises instead of falling back."""
    assert "ac.cpp" in build.SOURCES
    assert ac_native.available(str(tmp_path / "ok"))
    assert [p.name for p in (tmp_path / "ok").iterdir()] == [
        __import__("os").path.basename(build.lib_path(str(tmp_path / "ok")))]
    monkeypatch.setattr(build, "CXXFLAGS", [*build.CXXFLAGS, "-fno-such-option"])
    with pytest.raises(build.NativeBuildError):
        build.load_library(str(tmp_path / "bad"))
    assert not ac_native.available(str(tmp_path / "bad"))
