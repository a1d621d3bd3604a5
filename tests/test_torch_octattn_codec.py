"""The port's OctAttention codec (scp_tpu_torch/codec/octattn_codec.py)
against scp_tpu's, in f32 on the CPU, on a tiny model carried across by
scp_tpu_torch.weights and a small cloud (tests/test_octattn_rans.py's):
every schedule roundtrips losslessly (the fused and the per-position
"steps" device-rANS schedules, the host-coder incremental "incr"
schedule, the fast and sequential window schedules, and a 3-subtree
shared rANS stream), and its bits are within RATE_RTOL of scp_tpu's on
the same cloud.  The CDF rows agree with scp_tpu's within rounding (the
logits within tests/test_torch_octattention.py's tolerance), never whole
streams: the backend stamps differ.  Within the port, fused and steps
give the same payload, and the rANS payload pays the host coder's rate
on the same rows within the coders' constants."""

import numpy as np
import pytest
import torch

from scp_tpu import ac as jac
from scp_tpu.cli.codec_common import MULLEVEL_PATHS
from scp_tpu.codec import octattn_rans as jorans
from scp_tpu.codec.octattn_codec import OctAttentionCodec as JCodec
from scp_tpu.core import build_octree as jbuild_octree
from scp_tpu.core import gen_context as jgen_context
from scp_tpu.models.octattention import OctAttention as JOctAttention
from scp_tpu_torch import ac as tac
from scp_tpu_torch import weights
from scp_tpu_torch.codec import octattn_rans as torans
from scp_tpu_torch.codec.octattn_codec import OctAttentionCodec as TCodec
from scp_tpu_torch.core.preprocess import preprocess_points
from scp_tpu_torch.models.octattention import OctAttention as TOctAttention
from test_torch_octattention import random_variables

# bits vs scp_tpu's: the CDF rows agree within rounding, so a payload may
# differ by a byte or two (tests/test_torch_cli.py's RATE_RTOL)
RATE_RTOL = 1e-3
# quantized CDF entries vs scp_tpu's: logits within 1e-5 move an entry of
# 65536 by a unit or two at most
CDF_ATOL = 3
TINY = dict(occ_embed_dim=16, level_embed_dim=4, octant_embed_dim=4, abs_pos_embed_dim=8,
            num_layers=2, num_heads=2, hidden_dim=64, context_size=32)


def small_cloud(rng, n=60, bits=4):
    return np.unique(rng.integers(0, 2**bits, size=(n, 3)), axis=0)


def lidar_like(rng, n):
    r, az, el = rng.uniform(2.0, 60.0, n), rng.uniform(0, 2 * np.pi, n), rng.uniform(-0.4, 0.2, n)
    return np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az), r * np.sin(el)], 1)


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
    """scp_tpu's host coder pinned to its Python backend: its native build
    shares one <so>.tmp across test workers (the two backends give the same
    bytes)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCP_TPU_NO_NATIVE", "1")
        yield


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    jm = JOctAttention(**TINY)
    variables = random_variables(rng, jm)
    tm = weights.load_into(TOctAttention(**TINY, device="cpu"), variables)
    ctx = jgen_context(jbuild_octree(small_cloud(np.random.default_rng(1), n=120, bits=5)))
    return jm, variables, tm, ctx


def _rans_roundtrip(codec, ctxs):
    enc = codec.new_rans_encoder(max(codec.max_lane_bucket(c) for c in ctxs))
    for c in ctxs:
        codec.encode_incremental_into(enc, c)
    ideal = enc.ideal_bits()
    payload = enc.finish()
    # the payload exceeds the ideal bits of its CDF rows only by the
    # coder's constants: 32 bits of state per lane and the 2-byte header
    assert ideal <= len(payload) * 8 <= ideal + 32 * enc.k + 16
    dec = codec.new_rans_decoder(payload)
    for c in ctxs:
        _, occ, ml = codec.split_levels(c)
        codes = codec.decode_incremental_rans(dec, ml, ground_truth=occ)
        np.testing.assert_array_equal(codes, occ)
    return payload


def test_rans_fused_and_steps_lossless_with_jax_bits(models):
    jm, variables, tm, ctx = models
    fused = _rans_roundtrip(TCodec(tm), [ctx])
    steps = _rans_roundtrip(TCodec(tm, fused=False), [ctx])
    assert steps == fused  # same ops on the same values
    jcodec = JCodec(jm, variables, mode="rans")
    jenc = jorans.OctRansEncoder(jcodec.max_lane_bucket(ctx))
    jcodec.encode_incremental_into(jenc, ctx)
    jpay = jenc.finish()
    assert abs(len(fused) - len(jpay)) * 8 <= RATE_RTOL * len(jpay) * 8 + 16
    assert TCodec(tm).coding_params() == "dtype=float32;octsched=fused;cap=2097152;backend=torch-cpu"
    assert TCodec(tm, fused=False).coding_params() == "dtype=float32;octsched=steps;backend=torch-cpu"


def test_incr_rows_match_jax_and_roundtrip(models):
    """The host-coder incremental schedule: CDF rows against scp_tpu's
    within rounding, the py and native coders' streams equal, lossless."""
    jm, variables, tm, ctx = models
    codec = TCodec(tm, mode="full")
    rows, syms, _ = codec.encode_incremental(ctx)
    jrows, jsyms, _ = JCodec(jm, variables, mode="full").encode_incremental(ctx)
    np.testing.assert_array_equal(syms, jsyms)
    assert rows.shape == jrows.shape
    np.testing.assert_allclose(rows.astype(np.int64), np.asarray(jrows).astype(np.int64),
                               atol=CDF_ATOL, rtol=0)
    streams = []
    for native in (True, False):
        enc = tac.StreamingEncoder(native=native)
        enc.append_quantized(rows, syms)
        streams.append(enc.finish()[0])
    assert streams[0] == streams[1]
    jenc = jac.StreamingEncoder()
    jenc.append_quantized(jrows, jsyms)
    jstream, _ = jenc.finish()
    assert abs(len(streams[0]) - len(jstream)) <= RATE_RTOL * len(jstream) + 2
    _, occ, ml = codec.split_levels(ctx)
    codes = codec.decode_incremental(tac.ArithmeticDecoder(streams[0], len(syms)), ml,
                                     ground_truth=occ)
    np.testing.assert_array_equal(codes, occ)
    # the rANS payload pays the same model rate within the coders' constants
    payload = _rans_roundtrip(TCodec(tm), [ctx])
    assert len(payload) * 8 < len(streams[0]) * 8 + 64 * torans.lane_bucket(4) + 512


@pytest.mark.parametrize("sequential, level_wise", [(False, True), (False, False),
                                                    (True, True)])
def test_window_schedules_lossless_with_jax_bits(models, sequential, level_wise):
    jm, variables, tm, ctx = models
    codec = TCodec(tm, mode="full")
    pdf, syms, _ = codec.encode(ctx, sequential=sequential, level_wise=level_wise)
    jpdf, jsyms, _ = JCodec(jm, variables, mode="full").encode(
        ctx, sequential=sequential, level_wise=level_wise)
    np.testing.assert_array_equal(syms, jsyms)
    np.testing.assert_allclose(tac.pdf_to_quantized_cdf(pdf).astype(np.int64),
                               jac.pdf_to_quantized_cdf(np.asarray(jpdf)).astype(np.int64),
                               atol=CDF_ATOL, rtol=0)
    stream, bits = tac.ArithmeticEncoder().encode(pdf, syms)
    jstream, jbits = jac.ArithmeticEncoder().encode(np.asarray(jpdf), jsyms)
    assert abs(bits - jbits) <= RATE_RTOL * jbits + 16
    _, occ, ml = codec.split_levels(ctx)
    codes = codec.decode(tac.ArithmeticDecoder(stream, len(syms)), ml, ground_truth=occ,
                         sequential=sequential, level_wise=level_wise)
    np.testing.assert_array_equal(codes, occ)


def test_mullevel_shared_rans_stream(models):
    """Three subtrees through one OctRansEncoder / OctRansDecoder: the lane
    states persist across subtrees."""
    _, _, tm, _ = models
    pts = lidar_like(np.random.default_rng(2), 300)
    ctxs = [preprocess_points(pts, system="spher", qs=(60 / 63) / 2**j, morton_path=mp).context
            for j, mp in enumerate(MULLEVEL_PATHS)]
    _rans_roundtrip(TCodec(tm), ctxs)


def test_wrong_schedule_decode_raises(models):
    """A window-schedule stream decoded on the incremental schedule fails
    loudly, not deep inside the coder."""
    _, _, tm, ctx = models
    codec = TCodec(tm, mode="full")
    pdf, syms, _ = codec.encode(ctx)
    stream, _ = tac.ArithmeticEncoder().encode(pdf, syms)
    _, _, ml = codec.split_levels(ctx)
    with pytest.raises((ValueError, AssertionError)):
        codec.decode_incremental(tac.ArithmeticDecoder(stream, len(syms)), ml)
    with pytest.raises(ValueError, match="mode"):
        TCodec(tm, mode="staged")
