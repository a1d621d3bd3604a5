"""The port's staged (two-nibble) CDF factorization (scp_tpu_torch.codec.
staged) against scp_tpu's on the CPU.

`staged_cdfs` is held against JAX's jitted `staged_cdfs` (not against its
numpy mirror, which scp_tpu itself says is not bit-identical to its
device program) on peaked, flat and underflowed logit rows.  The two
compute the same f32 softmax, cumsums and quotients, but XLA sums the 255
exponentials in another order than PyTorch: on these rows 57-64% of the
softmax denominators differ in the last bit.  One f32 ulp of a CDF value
near 1 (2^-24) moves its scaled value (x 65520) by 0.004, so an entry
whose inputs differ flips its rounding with a chance of up to about
0.4-0.8%; measured, 0.14-0.20% of the entries of peaked and flat rows
differ by one unit.  Limits: entries equal on >= 99.5% and within 1
everywhere; every row strictly increasing up to its wrapped top.  The
integer steps (`intervals`, `gather_cond_rows`) are bit-exact on identical
rows, the numpy oracles are copies, and the staged rate is within 2% of
the single-stage rate (scp_tpu's own bound) on the port's host coder."""

import jax
import numpy as np
import pytest
import torch

from scp_tpu.codec import staged as jstaged
from scp_tpu_torch import ac as tac
from scp_tpu_torch.codec import staged as tstaged

SAME_SHARE = 0.995  # quantized entries equal to JAX's (see the docstring)
MAX_STEP = 1  # units of 65536 anywhere else


def _peaked(rng, n, scale=4.0):
    """Random logits with a dominant symbol, as a trained model gives."""
    x = rng.normal(0, 1, (n, 255)).astype(np.float32)
    x[np.arange(n), rng.integers(0, 255, n)] += scale
    return x


def _flat(rng, n):
    return rng.normal(0, 0.01, (n, 255)).astype(np.float32)


def _underflowed(rng, n):
    """All mass on a few symbols: most conditional rows underflow to 0."""
    x = np.full((n, 255), -1e9, np.float32)
    x[np.arange(n), rng.integers(0, 255, n)] = 0.0
    x[np.arange(n), rng.integers(0, 255, n)] = rng.normal(0, 2, n).astype(np.float32)
    return x


def _syms(rng, logits):
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.array([rng.choice(255, p=row) for row in p], dtype=np.int64)


def _host_intervals(hi_cdf, cond_cdf, syms):
    n = syms.shape[0]
    hi, lo = syms >> 4, syms & 15
    rows = cond_cdf[np.arange(n), hi]
    iv = np.zeros((n, 2, 2), np.uint16)
    iv[:, 0, 0], iv[:, 0, 1] = hi_cdf[np.arange(n), hi], hi_cdf[np.arange(n), hi + 1]
    iv[:, 1, 0], iv[:, 1, 1] = rows[np.arange(n), lo], rows[np.arange(n), lo + 1]
    return iv


def _port(logits):
    hi, cond = tstaged.staged_cdfs(torch.from_numpy(logits))
    return hi.numpy().astype(np.uint16), cond.numpy().astype(np.uint16)


def _strictly_increasing(rows):
    """Each row increases strictly; the last entry is the wrapped top (0)
    or above its predecessor (an underflowed row's plain ramp)."""
    r = rows.reshape(-1, rows.shape[-1]).astype(np.int64)
    assert (np.diff(r[:, :-1], axis=1) > 0).all()
    assert ((r[:, -1] == 0) | (r[:, -1] > r[:, -2])).all()


@pytest.mark.parametrize("kind", ["peaked", "flat", "underflowed"])
def test_staged_cdfs_match_jax_jitted(kind):
    rng = np.random.default_rng({"peaked": 1, "flat": 2, "underflowed": 3}[kind])
    logits = {"peaked": _peaked, "flat": _flat, "underflowed": _underflowed}[kind](rng, 512)
    j_hi, j_cond = (np.asarray(a) for a in jax.jit(jstaged.staged_cdfs)(logits))
    t_hi, t_cond = _port(logits)
    assert t_hi.shape == j_hi.shape == (512, 17)
    assert t_cond.shape == j_cond.shape == (512, 16, 17)
    for got, want in ((t_hi, j_hi), (t_cond, j_cond)):
        diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
        same = float((diff == 0).mean())
        print(f"{kind}: {same:.6f} of {got.size} entries equal, max step {diff.max()}")
        assert same >= SAME_SHARE and diff.max() <= MAX_STEP
        _strictly_increasing(got)
    # the numpy oracle is scp_tpu's, bit for bit
    for got, want in zip(tstaged.staged_cdfs_np(logits), jstaged.staged_cdfs_np(logits)):
        np.testing.assert_array_equal(got, want)


def test_intervals_and_row_gathers_bit_exact_on_jax_rows():
    rng = np.random.default_rng(4)
    logits = _peaked(rng, 200)
    syms = _syms(rng, logits)
    hi_cdf, cond_cdf = jstaged.staged_cdfs_np(logits)
    want_iv = np.asarray(jax.jit(jstaged.intervals)(hi_cdf, cond_cdf, syms.astype(np.int32)))
    got_iv = tstaged.intervals(torch.from_numpy(hi_cdf.astype(np.int32)),
                               torch.from_numpy(cond_cdf.astype(np.int32)),
                               torch.from_numpy(syms))
    np.testing.assert_array_equal(got_iv.numpy().astype(np.uint16), want_iv)
    np.testing.assert_array_equal(want_iv, _host_intervals(hi_cdf, cond_cdf, syms))
    hi = (syms >> 4).astype(np.int32)
    want_rows = np.asarray(jax.jit(jstaged.gather_cond_rows)(cond_cdf, hi))
    got_rows = tstaged.gather_cond_rows(torch.from_numpy(cond_cdf.astype(np.int32)),
                                        torch.from_numpy(hi))
    np.testing.assert_array_equal(got_rows.numpy().astype(np.uint16), want_rows)
    # batched layout (lanes, width): the codec's call shape
    got2 = tstaged.gather_cond_rows(torch.from_numpy(cond_cdf.astype(np.int32)).reshape(4, 50, 16, 17),
                                    torch.from_numpy(hi).reshape(4, 50))
    np.testing.assert_array_equal(got2.reshape(200, 17).numpy().astype(np.uint16), want_rows)


def test_staged_rate_within_two_percent_of_single_stage():
    """P(hi) * P(lo | hi) == P(sym): the staged rate on the port's coder
    is the 255-way rate up to quantization (scp_tpu's own 2% bound)."""
    rng = np.random.default_rng(5)
    logits = _peaked(rng, 400, scale=5.0)
    syms = _syms(rng, logits)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    _, bits_full = tac.ArithmeticEncoder().encode(p.astype(np.float32), syms.astype(np.int16))
    hi_cdf, cond_cdf = _port(logits)
    iv = tstaged.intervals(*(torch.from_numpy(a.astype(np.int32)) for a in (hi_cdf, cond_cdf)),
                           torch.from_numpy(syms)).numpy().astype(np.uint16)
    np.testing.assert_array_equal(iv, _host_intervals(hi_cdf, cond_cdf, syms))
    enc = tac.StreamingEncoder()
    enc.append_intervals(iv[:, 0])
    enc.append_intervals(iv[:, 1])
    stream, bits_staged = enc.finish()
    print(f"bits: staged {bits_staged}, single stage {bits_full}")
    assert abs(bits_staged - bits_full) / bits_full < 0.02
    assert bits_staged <= tstaged.staged_bits_np(hi_cdf, cond_cdf, syms) + 64
    assert tstaged.staged_bits_np(hi_cdf, cond_cdf, syms) == jstaged.staged_bits_np(
        hi_cdf, cond_cdf, syms)
    # decode: the hi stage on the hi rows, the lo stage on the gathered rows
    dec = tac.ArithmeticDecoder(stream, 2 * len(syms))
    got_hi = dec.decode_batch_quantized(hi_cdf)
    got_lo = dec.decode_batch_quantized(cond_cdf[np.arange(len(syms)), got_hi])
    np.testing.assert_array_equal(got_hi * 16 + got_lo, syms)


def test_underflowed_conditionals_still_code():
    """All-zero conditionals degrade to the quantization ramp; every symbol
    stays codable (scp_tpu's test_degenerate_conditionals_still_code)."""
    logits = np.full((8, 255), -1e9, np.float32)
    logits[:, 0] = 0.0
    syms = np.array([0, 17, 42, 100, 200, 254, 33, 250], np.int64)
    hi_cdf, cond_cdf = _port(logits)
    _strictly_increasing(hi_cdf)
    _strictly_increasing(cond_cdf)
    iv = _host_intervals(hi_cdf, cond_cdf, syms)
    enc = tac.StreamingEncoder()
    enc.append_intervals(iv[:, 0])
    enc.append_intervals(iv[:, 1])
    stream, _ = enc.finish()
    dec = tac.ArithmeticDecoder(stream, 2 * len(syms))
    got_hi = dec.decode_batch_quantized(hi_cdf)
    got_lo = dec.decode_batch_quantized(cond_cdf[np.arange(len(syms)), got_hi])
    np.testing.assert_array_equal(got_hi * 16 + got_lo, syms)
