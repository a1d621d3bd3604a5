"""The rANS coder's CUDA kernels (ops/csrc/rans.cu) against the plain step
loops of codec/rans.py.

On the CPU: the coder runs the plain loops and never a kernel, the
wrappers refuse CPU tensors, and the launchers' ctypes signatures.  On
the card (marker `cuda`; they skip without one): the kernels themselves
against the plain loops.  This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_rans_kernel.py
"""

import ctypes

import numpy as np
import pytest
import torch

from scp_tpu_torch.codec import rans
from scp_tpu_torch.codec.ehem_codec import logits_to_cdf
from scp_tpu_torch.ops import _cuda
from scp_tpu_torch.utils import profiling

K = rans.K_LANES
# group sizes of one stream: over a chunk, exactly a chunk, odd, one lane
# past and short of a step, tiny, and whole steps with the chunk's later
# steps empty
GROUPS = {
    "over_chunk": [rans.CHUNK + 4099, 2047, 5],
    "chunk": [rans.CHUNK, K + 1, K - 1],
    "small": [2047, K + 1, K - 1, 5, 3 * K],
}


def make_rows(rng, n: int, kind: str) -> tuple[np.ndarray, np.ndarray]:
    """(rows (pad_to_chunk(n), 256) int32 as the codec makes them, symbols
    (n,)): `random` logits, `uniform` rows, or `peaked` rows whose one
    symbol has freq 65536 - 254 (most steps then renormalise no lane)."""
    n_pad = rans.pad_to_chunk(n)
    if kind == "peaked":
        peak = rng.integers(0, 255, n)
        freq = np.ones((n, 255), np.int64)
        freq[np.arange(n), peak] = 65536 - 254
        cdf = np.concatenate([np.zeros((n, 1), np.int64), np.cumsum(freq, 1)], 1)
        rows = (cdf & 0xFFFF).astype(np.int32)
        syms = np.where(rng.random(n) < 0.9, peak, rng.integers(0, 255, n))
    else:
        scale = 3.0 if kind == "random" else 0.0
        logits = torch.from_numpy(rng.normal(0.0, scale, (n, 255)).astype(np.float32))
        rows = logits_to_cdf(logits).numpy()
        p = torch.softmax(logits, -1).double().numpy()
        u = rng.random((n, 1))
        syms = np.minimum((np.cumsum(p, 1) < u).sum(1), 254)
    out = np.zeros((n_pad, 256), np.int32)
    out[:n] = rows
    return out, syms.astype(np.int64)


def make_stream(sizes, kind, seed=0):
    rng = np.random.default_rng(seed)
    return [(*make_rows(rng, n, kind), n) for n in sizes]


def plain_encode(groups) -> bytes:
    enc = rans.RansEncoder("cpu")
    for rows, syms, n in groups:
        sp = np.zeros(rows.shape[0], np.int64)
        sp[:n] = syms
        enc.append_group(rans.gather_start_freq(torch.from_numpy(rows), torch.from_numpy(sp)), n)
    return enc.finish()


def test_cpu_coder_runs_the_plain_loops():
    """A coder on the CPU launches no kernel: the plain loops stay the
    path that tests/test_torch_codec.py holds against JAX."""
    groups = make_stream([2047, 5], "random", seed=1)
    n_enc, n_dec = rans.encode_kernel.launches, rans.decode_group_kernel.launches
    with profiling.recording():
        payload = plain_encode(groups)
        dec = rans.RansDecoder(payload, "cpu")
        for rows, syms, n in groups:
            np.testing.assert_array_equal(dec.decode_group(torch.from_numpy(rows), n)[:n], syms)
        counters = profiling.drain()["counters"]
    assert rans.encode_kernel.launches == n_enc
    assert rans.decode_group_kernel.launches == n_dec
    assert not any("rans.launches" in c for c in counters.values())
    assert sum(c.get("rans.steps", 0) for c in counters.values()) == 2 * (2 + 1)


def test_kernel_wrappers_refuse_cpu_tensors():
    rows, syms, n = make_stream([5], "random")[0]
    dec = rans.RansDecoder(plain_encode([(rows, syms, n)]), "cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        rans.decode_group_kernel(dec.states, dec.ptr, dec.stream, torch.from_numpy(rows), n)
    sf = rans.gather_start_freq(torch.from_numpy(rows), torch.zeros(rows.shape[0]))
    with pytest.raises(ValueError, match="CUDA tensor"):
        rans.encode_kernel([(sf, n)], "cuda")


def test_signatures_declare_the_rans_launchers():
    """Pointers and the stream pass as c_void_p, 64-bit sizes as c_longlong:
    ctypes would cut an undeclared pointer to 32 bits."""
    assert "rans.cu" in _cuda.SOURCES
    sig = _cuda._SIGNATURES["rans.cu"]
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    assert sig["scp_rans_decode_group"] == [p, ll, ll, p, ll, p, p, p, p]
    assert sig["scp_rans_encode"] == [p, i, p, ll, p, p]


# ---- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def card_encode(groups, device) -> bytes:
    enc = rans.RansEncoder(device)
    for rows, syms, n in groups:
        sp = np.zeros(rows.shape[0], np.int64)
        sp[:n] = syms
        enc.append_group(rans.gather_start_freq(torch.from_numpy(rows).to(device),
                                                torch.from_numpy(sp).to(device)), n)
    return enc.finish()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "uniform", "peaked"])
@pytest.mark.parametrize("case", sorted(GROUPS))
def test_rans_kernels_match_plain_loops_on_card(cuda_device, case, kind):
    """The same bytes from finish(); the same symbols and (states, ptr)
    after every decode_group; one launch per group in decode, one per
    finish."""
    groups = make_stream(GROUPS[case], kind)
    payload = plain_encode(groups)
    n_enc = rans.encode_kernel.launches
    assert card_encode(groups, cuda_device) == payload
    assert rans.encode_kernel.launches == n_enc + 1
    plain = rans.RansDecoder(payload, "cpu")
    card = rans.RansDecoder(payload, cuda_device)
    with profiling.recording():
        for rows, syms, n in groups:
            want = plain.decode_group(torch.from_numpy(rows), n)
            got = card.decode_group(torch.from_numpy(rows).to(cuda_device), n)
            torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
            np.testing.assert_array_equal(want[:n].numpy(), syms)
            torch.testing.assert_close(card.states.cpu(), plain.states, rtol=0, atol=0)
            assert int(card.ptr) == int(plain.ptr)
        counters = profiling.drain()["counters"]
    assert sum(c.get("rans.launches", 0) for c in counters.values()) == len(groups)


@pytest.mark.cuda
def test_rans_kernel_and_plain_streams_cross_decode_on_card(cuda_device):
    """The kernel decodes the plain encoder's stream, and the plain decoder
    the kernel's."""
    groups = make_stream(GROUPS["over_chunk"], "random", seed=3)
    for payload, device in ((plain_encode(groups), cuda_device),
                            (card_encode(groups, cuda_device), "cpu")):
        dec = rans.RansDecoder(payload, device)
        for rows, syms, n in groups:
            got = dec.decode_group(torch.from_numpy(rows).to(device), n)
            np.testing.assert_array_equal(got[:n].cpu().numpy(), syms)


@pytest.mark.cuda
def test_rans_empty_encoder_and_empty_group_on_card(cuda_device):
    """No group: the 2-byte header alone and no launch; a group of 0
    symbols decodes to zeros and leaves (states, ptr) as they were."""
    n_enc = rans.encode_kernel.launches
    assert rans.RansEncoder(cuda_device).finish() == rans.RansEncoder("cpu").finish()
    assert rans.encode_kernel.launches == n_enc
    groups = make_stream([5], "random")
    dec = rans.RansDecoder(card_encode(groups, cuda_device), cuda_device)
    states = dec.states.clone()
    out = dec.decode_group(torch.zeros((rans.CHUNK, 256), dtype=torch.int32,
                                       device=cuda_device), 0)
    assert not out.any() and int(dec.ptr) == 0
    torch.testing.assert_close(dec.states, states, rtol=0, atol=0)
