"""The port's sharded codec (EHEMCodec(devices=...), the twin of scp_tpu's
EHEMCodec(mesh=...)) and the throughput pipeline of tools/bench.py
against scp_tpu on the CPU: the call plan with mesh_mult, a lossless
roundtrip over 8 CPU "devices" with scp_tpu's sharded codec's bits on
the same weights and cloud (tests/test_roundtrip.py:105-160), the stamp's
device count, and three clouds in flight with the serial payloads."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from scp_tpu.codec import ehem_codec as jcodec
from scp_tpu.codec.slices import split_levels as jsplit
from scp_tpu.core.preprocess import preprocess_points as jpreprocess
from scp_tpu.models.ehem import EHEM as JEHEM
from scp_tpu_torch import weights
from scp_tpu_torch.codec import ehem_codec as tcodec
from scp_tpu_torch.codec.slices import split_levels as tsplit
from scp_tpu_torch.core.preprocess import preprocess_points as tpreprocess
from scp_tpu_torch.models.ehem import EHEM as TEHEM
from scp_tpu_torch.tools.bench import pipeline_bench

# scp_tpu's sharded-codec test model (tests/test_roundtrip.py:113-121)
CFG = dict(self_depths=(2, 2), cross_depths=(1,), embed_dim=64, num_heads=2, window_size=16,
           mlp_ratio=2.0, knn_k=4)
BITS_RTOL = 1e-3  # the packages' CDF rows agree within f32 rounding, not bit for bit
SHARDS = ["cpu"] * 8


@pytest.fixture(scope="module", autouse=True)
def setup_env():
    """One intra-op thread (the codec runs many small ops, test workers
    share the cores); scp_tpu's numpy octree builder (its native build's
    shared temp file races under xdist: ROADMAP, traps); dynamic KNN on
    both sides (SCP_STATIC_KNN unset, the port's default)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCP_TPU_NO_NATIVE", "1")
        mp.delenv("SCP_STATIC_KNN", raising=False)
        yield
    torch.set_num_threads(n)


def lidar_like(rng, n):
    """tests/test_roundtrip.py's cloud."""
    r = rng.uniform(2.0, 60.0, n)
    az = rng.uniform(0, 2 * np.pi, n)
    el = rng.uniform(-0.4, 0.2, n)
    return np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az), r * np.sin(el)],
                    1)


@pytest.fixture(scope="module")
def models():
    jm = JEHEM(**CFG)
    variables = jm.init(jax.random.PRNGKey(0), np.zeros((1, 8, 4, 3), np.int32),
                        np.zeros((1, 8, 3), np.float32))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    return jm, variables, weights.load_into(TEHEM(**CFG, device="cpu"), variables)


def _slices(pts, jax_side=False):
    pre, split = (jpreprocess, jsplit) if jax_side else (tpreprocess, tsplit)
    return split(pre(pts, system="spher", qs=60.0 / 127).context, angular=True)


def _roundtrip(codec, sl, dec_codec=None):
    stream, bits, _ = codec.encode_to_stream(sl)
    d = dec_codec or codec
    codes = d.decode(d.new_stream_decoder(stream, len(sl.occ_stream),
                                          coding_params=codec.coding_params()),
                     sl.max_level, np.array(sl.pos_mm, np.int64), angular=True,
                     ground_truth=sl.occ_stream, level_sizes=sl.level_sizes)
    np.testing.assert_array_equal(codes, sl.occ_stream)
    return stream, bits


@pytest.mark.parametrize("csz,group,small", [(8192, 16, 1024), (64, 8, 32), (256, 4, 32)])
@pytest.mark.parametrize("mesh_mult", [2, 3, 4, 8])
def test_call_plan_with_mesh_mult_equals_jax(csz, group, small, mesh_mult):
    for n in [513, 1000, csz - 1, csz, 3 * csz // 2 + 1, 7 * csz, 14 * csz + 77,
              15 * csz + csz // 2 + 3, 40 * csz + 5, 123_456]:
        assert tcodec._call_plan(n, csz, group, small, mesh_mult) == jcodec._call_plan(
            n, csz, group, small, mesh_mult=mesh_mult), n


def test_sharded_roundtrip_over_8_devices_has_the_jax_sharded_codecs_bits(models):
    jm, variables, tm = models
    pts = lidar_like(np.random.default_rng(42), 1500)
    sl = _slices(pts)
    codec = tcodec.EHEMCodec(tm, context_size=64, group_size=8, devices=SHARDS)
    assert "group=8;" in codec.coding_params() and "devices=8;" in codec.coding_params()
    assert len(codec.replicas) == 8 and codec.replicas[0] is tm
    _, bits = _roundtrip(codec, sl)
    # work really ran in lane slices: a grouped call split over the 8 shards
    assert codec.last_devices == tuple(SHARDS)

    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    jc = jcodec.EHEMCodec(jm, variables, context_size=64, group_size=8, mesh=mesh, mode="rans")
    _, jbits, _ = jc.encode_to_stream(_slices(pts, jax_side=True))
    print(f"sharded codec bits: port {bits}, scp_tpu {jbits}")
    assert abs(bits - jbits) <= BITS_RTOL * jbits


def test_stream_of_another_device_count_is_refused(models):
    _, _, tm = models
    sl = _slices(lidar_like(np.random.default_rng(3), 600))
    two = tcodec.EHEMCodec(tm, context_size=64, group_size=8, devices=["cpu", "cpu"])
    stream, _ = _roundtrip(two, sl)
    for other in (tcodec.EHEMCodec(tm, context_size=64, group_size=8),
                  tcodec.EHEMCodec(tm, context_size=64, group_size=8, devices=["cpu"] * 4)):
        assert other.coding_params() != two.coding_params()
        with pytest.raises(ValueError, match="stream coded with"):
            other.new_stream_decoder(stream, len(sl.occ_stream),
                                     coding_params=two.coding_params())
    with pytest.raises(ValueError, match="device entropy coder"):
        tcodec.EHEMCodec(tm, context_size=64, mode="staged", devices=["cpu", "cpu"])


def test_pipeline_of_three_clouds_is_lossless_with_the_serial_payloads(models):
    _, _, tm = models
    codec = tcodec.EHEMCodec(tm, context_size=64, group_size=8, devices=["cpu", "cpu"])
    clouds = [_slices(lidar_like(np.random.default_rng(s), 500)) for s in range(3)]
    serial = [codec.encode_to_stream(sl)[0] for sl in clouds]
    wall, streams, codes = pipeline_bench(codec, clouds)
    assert wall > 0 and streams == serial
    for c, sl in zip(codes, clouds):
        np.testing.assert_array_equal(c, sl.occ_stream)
