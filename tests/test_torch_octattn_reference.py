"""The port's OctAttention against the benchmark's plain reference
(benchmark/reference/octattention.py), in f32 on the CPU at a small size
(2 layers, context 32, 4 lanes), and the spans and counters of its
device-rANS path.

  * `decode_step` / `decode_insert` through the KV cache give, at every
    position of every lane, the logits of the reference's full
    (non-cached) forward over the lanes' windows;
  * a fused rans roundtrip under `profiling.recording()` opens
    octattn.encode / decode once per direction, octattn.level once per
    level loop, octattn.fetch at each blocking read, counts the level
    loops' positions and lanes, and writes the bytes it writes with
    recording off.

No JAX: the reference imports nothing of the port either."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness.octattn import nested  # noqa: E402
from benchmark.reference.octattention import Reference, exact_f32, fresh_params  # noqa: E402
from scp_tpu_torch import weights  # noqa: E402
from scp_tpu_torch.codec import octattn_rans as orans  # noqa: E402
from scp_tpu_torch.codec.octattn_codec import OctAttentionCodec  # noqa: E402
from scp_tpu_torch.core.preprocess import kitti_qs, preprocess_points  # noqa: E402
from scp_tpu_torch.models.octattention import OctAttention  # noqa: E402
from scp_tpu_torch.utils import profiling  # noqa: E402

WIDTHS = {"occ_embed_dim": 16, "level_embed_dim": 4, "octant_embed_dim": 4,
          "abs_pos_embed_dim": 8, "level_k": 4, "layer_num": 2, "head_num": 2,
          "hidden_dimension": 64, "context_size": 32, "token_num": 255, "max_octree_level": 12}
LANES = 4
# logits of the cached step loop against the dense window forward, f32:
# the two sum the same softmax-weighted values in another order (the step
# reads j cached rows plus its own slot, the window all rows with exact
# zeros past the diagonal), so they differ by f32 rounding of O(1) logits
# through two layers; 1e-4 is about 100 ulps at the logits' scale
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: thousands of small ops, several test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    params = fresh_params(WIDTHS, torch.Generator().manual_seed(3), "cpu")
    w = WIDTHS
    model = OctAttention(occ_embed_dim=w["occ_embed_dim"], level_embed_dim=w["level_embed_dim"],
                         octant_embed_dim=w["octant_embed_dim"],
                         abs_pos_embed_dim=w["abs_pos_embed_dim"],
                         max_octree_level=w["max_octree_level"], num_layers=w["layer_num"],
                         num_heads=w["head_num"], hidden_dim=w["hidden_dimension"],
                         context_size=w["context_size"], ancestors=w["level_k"], device="cpu")
    return weights.load_into(model, nested(params)), Reference(params, WIDTHS)


def _windows(seed, lanes, n):
    rng = np.random.default_rng(seed)
    data = np.stack([rng.integers(0, 255, (lanes, n, 4)), rng.integers(0, 13, (lanes, n, 4)),
                     rng.integers(0, 9, (lanes, n, 4))], -1).astype(np.int32)
    return torch.from_numpy(data), torch.from_numpy(rng.random((lanes, n, 4, 3), np.float32))


def test_kv_cache_steps_match_the_reference_forward(pair):
    model, ref = pair
    n = WIDTHS["context_size"]
    data, pos = _windows(5, LANES, n)
    with torch.no_grad(), exact_f32():
        want = ref.forward(data, pos)
        cache = model.init_cache(LANES)
        got = []
        for j in range(n):
            d_j = data[:, j].clone()
            d_j[:, -1, 0] = 255  # the step never reads its own occupancy
            logits, qs = model.decode_step(d_j, pos[:, j], cache, j)
            got.append(logits)
            model.decode_insert(data[:, j], pos[:, j], cache, j, qs)
    got = torch.stack(got, 1)
    assert got.shape == want.shape == (LANES, n, 255)
    err = float((got - want).abs().max())
    assert err <= LOGIT_TOL * max(1.0, float(want.abs().max())), err


def _roundtrip(codec, rows):
    levels, occ, max_level = codec.split_levels(rows)
    enc = codec.new_rans_encoder(codec.max_lane_bucket(rows))
    codec.encode_incremental_into(enc, rows)
    payload = enc.finish()
    codes = codec.decode_incremental_rans(codec.new_rans_decoder(payload), max_level)
    return payload, codes, occ, [d.shape[0] for d, _ in levels]


def test_fused_rans_records_its_spans_and_keeps_its_bytes(pair):
    model, _ = pair
    codec = OctAttentionCodec(model, mode="rans", fused=True)
    pts = np.random.default_rng(7).normal(0.0, 20.0, (400, 3))
    rows = preprocess_points(pts, system="spher", qs=kitti_qs(7)).context
    profiling.drain()
    off, codes_off, occ, sizes = _roundtrip(codec, rows)
    assert profiling.drain() == {"spans": [], "counters": {}}
    with profiling.recording(), profiling.unit(0):
        on, codes_on, _, _ = _roundtrip(codec, rows)
    rec = profiling.drain()
    assert on == off
    assert (codes_on == occ).all() and (codes_off == occ).all()
    names = [s.name for s in rec["spans"]]
    csz = WIDTHS["context_size"]
    assert names.count("octattn.encode") == names.count("octattn.decode") == 1
    assert names.count("octattn.level") == 2 * len(sizes)
    # a level's symbols on decode, finish()'s totals, body and lane states
    assert names.count("octattn.fetch") == len(sizes) + 3
    spans = {s.id: s for s in rec["spans"]}
    for s in rec["spans"]:
        if s.name == "octattn.level":
            assert spans[s.parent].name in ("octattn.encode", "octattn.decode")
    positions = sum(min(csz, n) for n in sizes)
    lanes = sum(min(csz, n) * orans.lane_bucket(-(-n // csz)) for n in sizes)
    assert rec["counters"] == {0: {"octattn.positions": 2 * positions,
                                   "octattn.lanes": 2 * lanes}}
