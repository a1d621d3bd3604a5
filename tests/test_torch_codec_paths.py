"""The codec paths off the spherical, unclipped main path, held against the
JAX package on the CPU: a cartesian (angular=False) roundtrip, whose
positions normalize by 2^max_level, and a spherical roundtrip with the
deepest level's level channel clipped (`lidar_clip`, what scp_tpu's CLI
passes).  Both lossless, with the JAX codec's bits on the same cloud and
weights.  The stream stamp's attention-numerics and GEMM fields are
checked too, and the host-coder modes (staged, full) on a cylindrical
cloud."""

import numpy as np
import pytest

from scp_tpu.codec import ehem_codec as jcodec
from scp_tpu.codec.slices import split_levels as jsplit
from scp_tpu.core import build_octree as jbuild_octree
from scp_tpu.core import gen_context as jgen_context
from scp_tpu.core.preprocess import preprocess_points as jpreprocess
from scp_tpu.models.ehem import EHEM as JEHEM
from scp_tpu_torch import weights
from scp_tpu_torch.codec import ehem_codec as tcodec
from scp_tpu_torch.codec.slices import split_levels as tsplit
from scp_tpu_torch.core.octree import build_octree, gen_context
from scp_tpu_torch.core.preprocess import preprocess_points as tpreprocess
from scp_tpu_torch.models.ehem import EHEM as TEHEM
from test_torch_pallas_config import random_variables


@pytest.fixture(scope="module", autouse=True)
def numpy_octree():
    """scp_tpu's octree builder takes its native library above 2048 keys,
    built at first use through one <so>.tmp that test workers share (a
    race that can fail tests/test_ac.py; ROADMAP, traps).  Its numpy path
    is the native builder's reference, so the octrees are the same."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCP_TPU_NO_NATIVE", "1")
        yield


CFG = dict(self_depths=(2, 1), cross_depths=(1,), embed_dim=64, num_heads=4,
           window_size=64, mlp_ratio=2.0, knn_k=4)
CONTEXT = 128


@pytest.fixture(scope="module")
def models():
    """JAX's and the port's model on one set of random weights (drawn at
    flax's shapes without running an init)."""
    jm = JEHEM(**CFG)
    variables = random_variables(np.random.default_rng(21), jm)
    tm = weights.load_into(TEHEM(**CFG, static_knn=True, device="cpu"), variables)
    return jm, variables, tm


def _roundtrip(tm, jm, variables, sl_t, sl_j, angular, clip):
    codec = tcodec.EHEMCodec(tm, context_size=CONTEXT)
    stream, bits, _ = codec.encode_to_stream(sl_t, lidar_clip=clip)
    codes = codec.decode(codec.new_stream_decoder(stream, len(sl_t.occ_stream),
                                                 coding_params=codec.coding_params()),
                         sl_t.max_level, np.array(sl_t.pos_mm, np.int64), angular=angular,
                         lidar_clip=clip, ground_truth=sl_t.occ_stream,
                         level_sizes=sl_t.level_sizes)
    np.testing.assert_array_equal(codes, sl_t.occ_stream)
    jc = jcodec.EHEMCodec(jm, variables, context_size=CONTEXT, mode="rans")
    _, jbits, _ = jc.encode_to_stream(sl_j, lidar_clip=clip)
    print(f"bits: port {bits}, JAX {jbits}")
    assert bits == jbits
    return bits


def test_cartesian_roundtrip_lossless_with_jax_bits(monkeypatch, models):
    monkeypatch.setenv("SCP_STATIC_KNN", "1")  # never "0": JAX reads it with bool()
    jm, variables, tm = models
    rng = np.random.default_rng(4)
    pts = np.unique(rng.integers(0, 2**8, size=(700, 3)), axis=0)
    ctx = gen_context(build_octree(pts))
    np.testing.assert_array_equal(ctx, jgen_context(jbuild_octree(pts)))
    sl = tsplit(ctx, angular=False)
    assert sum(n > tcodec.EHEMCodec.TINY_UNIFORM_MAX for n in sl.level_sizes) >= 2
    # positions normalize by 2^max_level, not by the level's min/max
    assert tcodec.EHEMCodec._norm_params((5, 9), sl.max_level, False) == (
        0, np.float32(1.0 / 2**sl.max_level))
    _roundtrip(tm, jm, variables, sl, jsplit(ctx, angular=False), False, None)


def test_lidar_clip_roundtrip_lossless_with_jax_bits(monkeypatch, models):
    monkeypatch.setenv("SCP_STATIC_KNN", "1")
    jm, variables, tm = models
    rng = np.random.default_rng(6)
    n = 700
    r, az, el = rng.uniform(2, 60, n), rng.uniform(0, 2 * np.pi, n), rng.uniform(-0.4, 0.2, n)
    pts = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                    r * np.sin(el)], 1)
    ctx_t = tpreprocess(pts, system="spher", qs=60.0 / 255).context
    ctx_j = jpreprocess(pts, system="spher", qs=60.0 / 255).context
    np.testing.assert_array_equal(ctx_t, ctx_j)
    max_level = int(ctx_t[:, -1, 1].max())
    clip = max_level - 3  # the deepest level's ancestors all sit above it
    sl_t = tsplit(ctx_t, angular=True, lidar_level_clip=clip)
    assert int(sl_t.data[-1][:, :, 0].max()) == clip
    bits = _roundtrip(tm, jm, variables, sl_t, jsplit(ctx_j, angular=True, lidar_level_clip=clip),
                      True, clip)
    # the clip changes what the model sees at the deepest level, so the bits
    codec = tcodec.EHEMCodec(tm, context_size=CONTEXT)
    _, unclipped, _ = codec.encode_to_stream(tsplit(ctx_t, angular=True))
    assert unclipped != bits


def test_stamp_names_the_attention_numerics_and_refuses_older_streams(models):
    _, _, tm = models
    codec = tcodec.EHEMCodec(tm, context_size=CONTEXT)
    stamp = codec.coding_params()
    assert f"attn={tcodec.ATTN_NUMERICS};" in stamp
    assert f"gemm={tcodec.GEMM_NUMERICS};" in stamp and tcodec.GEMM_NUMERICS == "sm90"
    # a stream written before each field existed (B/C weights rounded
    # unnormalized; the WMMA GEMMs' summation order) and ones with other
    # numerics
    attn, gemm = f"attn={tcodec.ATTN_NUMERICS};", f"gemm={tcodec.GEMM_NUMERICS};"
    bad = (stamp.replace(attn, ""), stamp.replace(attn, "attn=online;"),
           stamp.replace(gemm, ""), stamp.replace(gemm, "gemm=wmma;"),
           stamp.replace(attn, "").replace(gemm, ""))
    for other in bad:
        assert other != stamp
        with pytest.raises(ValueError, match="stream coded with"):
            codec.new_stream_decoder(b"\0" * 64, 1, coding_params=other)
    codec.new_stream_decoder(b"\0" * 64, 1, coding_params=stamp)


def test_cylindrical_roundtrip_lossless_with_jax_bits(monkeypatch, models):
    """The cylindrical system (scp_tpu's `--cylin`): angular, so positions
    normalize by each level's (min, max) of the radial / azimuth / height
    grid, as in spherical mode."""
    monkeypatch.setenv("SCP_STATIC_KNN", "1")
    jm, variables, tm = models
    rng = np.random.default_rng(8)
    n = 700
    r, az, z = rng.uniform(2, 60, n), rng.uniform(0, 2 * np.pi, n), rng.uniform(-3, 1, n)
    pts = np.stack([r * np.cos(az), r * np.sin(az), z], 1)
    ctx_t = tpreprocess(pts, system="cylin", qs=60.0 / 255).context
    ctx_j = jpreprocess(pts, system="cylin", qs=60.0 / 255).context
    np.testing.assert_array_equal(ctx_t, ctx_j)
    sl_t = tsplit(ctx_t, angular=True)
    assert sum(n > tcodec.EHEMCodec.TINY_UNIFORM_MAX for n in sl_t.level_sizes) >= 2
    _roundtrip(tm, jm, variables, sl_t, jsplit(ctx_j, angular=True), True, None)


@pytest.mark.parametrize("mode", ["staged", "full"])
def test_host_coder_modes_are_refused(monkeypatch, models, mode):
    """The host-coder modes (scp_tpu's staged and full, on the arithmetic
    coder) code a lossless cylindrical roundtrip with JAX's bits, with
    their coder steps per node (2 / 1); what the codec refuses is a mode
    that is none of rans, staged and full (ValueError)."""
    monkeypatch.setenv("SCP_STATIC_KNN", "1")
    monkeypatch.setenv("SCP_TPU_NO_NATIVE", "1")  # scp_tpu's coder on Python
    jm, variables, tm = models
    rng = np.random.default_rng(9)
    n = 500
    r, az, z = rng.uniform(2, 60, n), rng.uniform(0, 2 * np.pi, n), rng.uniform(-3, 1, n)
    pts = np.stack([r * np.cos(az), r * np.sin(az), z], 1)
    ctx = tpreprocess(pts, system="cylin", qs=60.0 / 255).context
    sl = tsplit(ctx, angular=True)
    codec = tcodec.EHEMCodec(tm, context_size=CONTEXT, mode=mode)
    assert codec.mode == mode and codec.ac_symbols_per_node == {"staged": 2, "full": 1}[mode]
    stream, bits, _ = codec.encode_to_stream(sl)
    dec = codec.new_stream_decoder(stream, codec.ac_symbols_per_node * len(sl.occ_stream),
                                   coding_params=codec.coding_params())
    codes = codec.decode(dec, sl.max_level, np.array(sl.pos_mm, np.int64), angular=True,
                         ground_truth=sl.occ_stream, level_sizes=sl.level_sizes)
    np.testing.assert_array_equal(codes, sl.occ_stream)
    jc = jcodec.EHEMCodec(jm, variables, context_size=CONTEXT, mode=mode)
    _, jbits, _ = jc.encode_to_stream(jsplit(jpreprocess(pts, system="cylin",
                                                         qs=60.0 / 255).context, angular=True))
    print(f"bits: port {bits}, JAX {jbits}")
    assert bits == jbits
    for bad in ("Staged", "ac", ""):
        with pytest.raises(ValueError, match="coding mode"):
            tcodec.EHEMCodec(tm, context_size=CONTEXT, mode=bad)
