"""EHEM's staged and full coding modes of the port (host arithmetic coder)
held against scp_tpu's `EHEMCodec(mode=...)` on the CPU, on a narrow
model with one set of random weights: lossless roundtrips with the
ground-truth check, the payload's bits equal to JAX's on the same slices
(as tests/test_torch_codec_paths.py holds the rans mode's), warmup's count
of phase shapes equal to JAX's, and several subtrees through one stream
(what --mullevel writes).  The CDF rows themselves match JAX's only within
rounding (tests/test_torch_staged.py); on these clouds that moves no
payload byte.

scp_tpu runs with SCP_STATIC_KNN=1 and SCP_TPU_NO_NATIVE=1 (its octree
and range coder on numpy / Python: its native build shares one <so>.tmp
across test workers)."""

import numpy as np
import pytest
import torch

from scp_tpu.codec import ehem_codec as jcodec
from scp_tpu.codec.slices import split_levels as jsplit
from scp_tpu.core.preprocess import preprocess_points as jpreprocess
from scp_tpu.models.ehem import EHEM as JEHEM
from scp_tpu_torch import weights
from scp_tpu_torch.codec import ehem_codec as tcodec
from scp_tpu_torch.codec.slices import split_levels as tsplit
from scp_tpu_torch.core.preprocess import preprocess_points as tpreprocess
from scp_tpu_torch.models.ehem import EHEM as TEHEM
from test_torch_pallas_config import random_variables

CFG = dict(self_depths=(2, 1), cross_depths=(1,), embed_dim=64, num_heads=4,
           window_size=64, mlp_ratio=2.0, knn_k=4)
CONTEXT = 128  # 16 full chunks (a grouped call) at 2048 nodes


@pytest.fixture(scope="module", autouse=True)
def switches():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCP_TPU_NO_NATIVE", "1")
        mp.setenv("SCP_STATIC_KNN", "1")  # never "0": scp_tpu reads it with bool()
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jm = JEHEM(**CFG)
    variables = random_variables(np.random.default_rng(21), jm)
    tm = weights.load_into(TEHEM(**CFG, static_knn=True, device="cpu"), variables)
    return jm, variables, tm


@pytest.fixture(scope="module")
def jax_codecs(models):
    """One scp_tpu codec per mode: its phase programs compile once."""
    jm, variables, _ = models
    return {m: jcodec.EHEMCodec(jm, variables, context_size=CONTEXT, mode=m)
            for m in ("staged", "full")}


def _sweep(seed, n):
    rng = np.random.default_rng(seed)
    r, az, el = rng.uniform(2, 60, n), rng.uniform(0, 2 * np.pi, n), rng.uniform(-0.4, 0.2, n)
    return np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                     r * np.sin(el)], 1)


@pytest.fixture(scope="module")
def clouds():
    """(port slices, JAX slices) of three clouds; the first has a level of
    >= 2048 nodes (a grouped (16, 128) call)."""
    out = []
    for seed, n in ((3, 2600), (4, 500), (5, 900)):
        pts = _sweep(seed, n)
        ctx = tpreprocess(pts, system="spher", qs=60.0 / 255).context
        np.testing.assert_array_equal(ctx, jpreprocess(pts, system="spher", qs=60.0 / 255).context)
        out.append((tsplit(ctx, angular=True), jsplit(ctx, angular=True)))
    assert max(out[0][0].level_sizes) >= 16 * CONTEXT
    return out


def _decode(codec, stream, n_sym, sl, dec=None):
    dec = dec or codec.new_stream_decoder(stream, n_sym, coding_params=codec.coding_params())
    codes = codec.decode(dec, sl.max_level, np.array(sl.pos_mm, np.int64), angular=True,
                         ground_truth=sl.occ_stream, level_sizes=sl.level_sizes)
    np.testing.assert_array_equal(codes, sl.occ_stream)
    return dec


def _same_bits(bits, jbits):
    print(f"bits: port {bits}, JAX {jbits}")
    assert bits == jbits


@pytest.mark.parametrize("mode", ["staged", "full"])
def test_roundtrip_lossless_with_jax_bits(models, jax_codecs, clouds, mode):
    _, _, tm = models
    sl_t, sl_j = clouds[0]
    codec = tcodec.EHEMCodec(tm, context_size=CONTEXT, mode=mode)
    jc = jax_codecs[mode]
    assert codec.warmup(sl_t) == jc.warmup(sl_j) == 3
    assert not codec.timers.totals  # warmup clears the timers
    stream, bits, _ = codec.encode_to_stream(sl_t)
    assert bits == len(stream) * 8
    n_sym = codec.ac_symbols_per_node * len(sl_t.occ_stream)
    assert codec.ac_symbols_per_node == jc.ac_symbols_per_node == {"staged": 2, "full": 1}[mode]
    _decode(codec, stream, n_sym, sl_t)
    assert {"dispatch_p1", "fetch_cdf", "ac_decode", "expand"} <= set(codec.timers.totals)
    print(codec.timers.report())
    _, jbits, _ = jc.encode_to_stream(sl_j)
    _same_bits(bits, jbits)
    # the rans stream of the same codec settings keeps its stamp
    assert codec.coding_params() == tcodec.EHEMCodec(tm, context_size=CONTEXT).coding_params()


@pytest.mark.parametrize("mode", ["staged", "full"])
def test_three_subtrees_through_one_stream(models, jax_codecs, clouds, mode):
    """encode_into three times on one encoder, decode subtree by subtree
    with one decoder (the --mullevel layout); bits equal to JAX's stream."""
    _, _, tm = models
    codec = tcodec.EHEMCodec(tm, context_size=CONTEXT, mode=mode)
    subtrees = [clouds[1], clouds[2], clouds[1]]
    enc = codec.new_stream_encoder()
    jc = jax_codecs[mode]
    jenc = jc.new_stream_encoder()
    for sl_t, sl_j in subtrees:
        codec.encode_into(enc, sl_t)
        jc.encode_into(jenc, sl_j)
    stream, bits, n_sym = codec.finish_stream(enc)
    _, jbits, jn_sym = jc.finish_stream(jenc)
    assert n_sym == jn_sym == codec.ac_symbols_per_node * sum(len(s.occ_stream)
                                                              for s, _ in subtrees)
    dec = None
    for sl_t, _ in subtrees:
        dec = _decode(codec, stream, n_sym, sl_t, dec)
    _same_bits(bits, jbits)
