"""The port's device rANS of the OctAttention incremental schedule
(scp_tpu_torch/codec/octattn_rans.py) against scp_tpu's on the CPU: on the
same position-major (rows, symbols) of several level schedules and lane
counts, the payloads are byte-identical and the port's decoder returns
every symbol; a corrupt lane header and a payload over the stream cap
raise, at decode as at encode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scp_tpu.codec import octattn_rans as jorans
from scp_tpu.codec import rans as jrans
from scp_tpu.codec.ehem_codec import logits_to_cdf as jlogits_to_cdf
from scp_tpu_torch.codec import octattn_rans as torans
from scp_tpu_torch.codec import rans as trans


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these tests run thousands of small torch ops,
    which crawl when every test worker's thread pool spans all the cores
    (the suite runs several workers on one machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def level_schedule(rng, level_sizes, csz):
    """Per level (n, rows (nsteps, lanes, 256) u16, syms (nsteps, lanes))
    in the position-major lane layout; inactive (step, lane) slots zero."""
    levels = []
    for n in level_sizes:
        lanes = torans.lane_bucket(-(-n // csz))
        max_m = min(csz, n)
        nsteps = 1 << max(max_m - 1, 0).bit_length()
        logits = rng.normal(0.0, 3.0, (nsteps * lanes, 255)).astype(np.float32)
        rows = np.array(jlogits_to_cdf(jnp.asarray(logits))).reshape(nsteps, lanes, 256)
        syms = rng.integers(0, 255, (nsteps, lanes)).astype(np.int32)
        for j in range(nsteps):
            cnt = torans.active_count(n, csz, j)
            rows[j, cnt:] = 0
            syms[j, cnt:] = 0
        levels.append((n, rows, syms))
    return levels


def encode_both(levels, csz, k):
    jenc = jorans.OctRansEncoder(k)
    tenc = torans.OctRansEncoder(k, "cpu")
    for n, rows, syms in levels:
        nsteps, lanes, _ = rows.shape
        jsf = jrans.gather_start_freq(jnp.asarray(rows.reshape(-1, 256)),
                                      jnp.asarray(syms.reshape(-1))).reshape(nsteps, lanes, 2)
        jenc.append_level(jsf, n, csz)
        tsf = trans.gather_start_freq(torch.from_numpy(rows.astype(np.int32)),
                                      torch.from_numpy(syms))
        tenc.append_level(tsf, n, csz)
    assert tenc.n_symbols == jenc.n_symbols
    return jenc.finish(), tenc.finish()


@pytest.mark.parametrize("sizes, csz, k", [
    ([1, 8, 31, 32, 33, 97, 200], 32, None),  # every lane count up to 8
    ([1, 1, 2, 250], 32, 8),  # one-node levels, then a wide one
    ([5, 700, 64, 3], 64, 16),  # lanes above the widest level's bucket
    ([1000], 16, None),  # 63 chunks -> 64 lanes, one level
])
def test_payload_bytes_equal_jax_and_decode(sizes, csz, k):
    rng = np.random.default_rng(sum(sizes) + csz)
    levels = level_schedule(rng, sizes, csz)
    k = k or torans.lane_bucket(max(-(-n // csz) for n in sizes))
    jpay, tpay = encode_both(levels, csz, k)
    assert tpay == jpay
    dec = torans.OctRansDecoder(tpay, "cpu")
    assert dec.k == k
    for n, rows, syms in levels:
        for j in range(min(csz, n)):
            cnt = torans.active_count(n, csz, j)
            got = dec.step(torch.from_numpy(rows[j].astype(np.int32)), cnt)
            np.testing.assert_array_equal(got[:cnt].numpy(), syms[j, :cnt])
            assert not got[cnt:].any()
    # every byte consumed, none past the payload
    assert int(dec.ptr) == len(tpay) - 2 - 4 * k


def test_lane_helpers_equal_jax():
    for n in (1, 5, 31, 32, 33, 100, 1000):
        assert torans.lane_bucket(-(-n // 32)) == jorans.lane_bucket(-(-n // 32))
        for j in range(min(40, n) + 2):
            assert torans.active_count(n, 32, j) == jorans.active_count(n, 32, j)


def test_corrupt_header_and_cap_raise():
    with pytest.raises(ValueError, match="shorter"):
        torans.OctRansDecoder(b"\x01", "cpu")
    with pytest.raises(ValueError, match="corrupt"):
        torans.OctRansDecoder(np.uint16(3).tobytes() + b"\0" * 12, "cpu")
    with pytest.raises(ValueError, match="corrupt"):
        torans.OctRansDecoder(np.uint16(4).tobytes() + b"\0" * 12, "cpu")  # 4 lanes, 3 states
    rng = np.random.default_rng(9)
    levels = level_schedule(rng, [300, 400], 32)
    _, tpay = encode_both(levels, 32, 16)
    body = len(tpay) - 2 - 4 * 16
    cap = body + 2 * 16 + 2  # exactly enough room for a step's window
    torans.OctRansDecoder(tpay, "cpu", cap=cap)
    with pytest.raises(ValueError, match="stream cap"):
        torans.OctRansDecoder(tpay, "cpu", cap=cap - 1)
    enc = torans.OctRansEncoder(16, "cpu", cap=cap - 1)
    for n, rows, syms in levels:
        enc.append_level(trans.gather_start_freq(torch.from_numpy(rows.astype(np.int32)),
                                                 torch.from_numpy(syms)), n, 32)
    with pytest.raises(ValueError, match="stream cap"):
        enc.finish()
    with pytest.raises(ValueError, match="power of two"):
        torans.OctRansEncoder(12, "cpu")
