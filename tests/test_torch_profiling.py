"""The port's span-and-counter recorder (scp_tpu_torch/utils/profiling.py)
and the spans the port opens: off it is one shared no-op; on, spans nest,
carry their unit and, under torch.profiler, lie on the trace's clock as
`scp.*` ranges; a rans-mode EHEM roundtrip opens every span of the
preprocessing, codec and entropy coder and writes the same stream as with
recording off; the trainer's parts and the loader's wait are spans, and
train_step(timings=...) keeps its keys.  No JAX."""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from scp_tpu_torch.codec import rans
from scp_tpu_torch.codec.ehem_codec import EHEMCodec
from scp_tpu_torch.codec.slices import split_levels
from scp_tpu_torch.config import Config, load_config
from scp_tpu_torch.core.octree import build_octree, gen_context
from scp_tpu_torch.core.preprocess import preprocess_points
from scp_tpu_torch.models.ehem import EHEM
from scp_tpu_torch.models.layers import flax_init_
from scp_tpu_torch.train.data import build_dataset, prefetch
from scp_tpu_torch.train.trainer import Trainer
from scp_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def clean():
    profiling.drain()
    yield
    assert profiling._ON is None  # every recording() block closed
    profiling.drain()


def _names(rec):
    return [s.name for s in rec["spans"]]


# ---- the recorder -------------------------------------------------------------


def test_off_is_one_shared_noop_that_reads_no_clock(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("read a clock or opened a profiler range while off")

    monkeypatch.setattr(profiling.time, "perf_counter_ns", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    a, b = profiling.span("x"), profiling.span("y")
    assert a is b is profiling.NOOP and profiling.unit(3) is profiling.NOOP
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with a, profiling.unit(3):
            with b:
                profiling.count("n", 5)
                torch.ones(4).add_(1)
    assert not any(e.name.startswith(profiling.PROFILER_PREFIX) for e in prof.events())
    assert profiling.drain() == {"spans": [], "counters": {}}


def test_spans_nest_with_parent_ids_units_and_counters():
    with profiling.recording():
        with profiling.unit("sweep0"):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    profiling.count("steps", 3)
                with profiling.span("inner"):
                    profiling.count("steps")
        with profiling.span("root"):
            profiling.count("steps", 7)
        with profiling.unit(1), profiling.recording():  # nested: one recording
            with profiling.span("other"):
                profiling.count("launches", 2)
    rec = profiling.drain()
    by = {s.id: s for s in rec["spans"]}
    assert _names(rec) == ["inner", "inner", "outer", "root", "other"]
    inner1, inner2, outer, root, other = rec["spans"]
    assert outer.parent == 0 and inner1.parent == inner2.parent == outer.id
    assert root.parent == 0 and other.parent == 0 and len(by) == 5
    assert [s.unit for s in rec["spans"]] == ["sweep0"] * 3 + [None, 1]
    for s in rec["spans"]:
        assert s.start_ns <= s.end_ns
    assert outer.start_ns <= inner1.start_ns and inner2.end_ns <= outer.end_ns
    assert rec["counters"] == {"sweep0": {"steps": 4}, None: {"steps": 7},
                               1: {"launches": 2}}
    assert profiling.drain() == {"spans": [], "counters": {}}  # drain clears
    with profiling.span("after"):  # off again after the block
        pass
    assert profiling.drain()["spans"] == []


def test_spans_lie_on_the_profilers_clock_around_their_ops():
    """Under a CPU torch.profiler a span is a `scp.<name>` range that
    contains the operators issued inside it and none issued outside."""
    x = torch.ones(64)
    with profiling.recording(), profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.sub(x, 1)
        with profiling.span("probe"):
            torch.add(x, 1)
            torch.mul(x, 2)
    evs = prof.events()
    ranges = [e for e in evs if e.name == "scp.probe"]
    assert len(ranges) == 1
    r = ranges[0].time_range

    def inside(name):
        ts = [e.time_range for e in evs if e.name == name]
        assert ts, name
        return all(r.start <= t.start and t.end <= r.end for t in ts)

    assert inside("aten::add") and inside("aten::mul") and not inside("aten::sub")
    assert _names(profiling.drain()) == ["probe"]


def test_timed_spans_time_with_recording_off_and_record_with_it_on():
    timers = profiling.StageTimers()
    with timers.stage("fetch_cdf"):
        pass
    with profiling.recording():
        with timers.stage("fetch_cdf"), timers.stage("ac_decode"):
            pass
    assert timers.counts == {"fetch_cdf": 2, "ac_decode": 1}
    assert timers.totals["fetch_cdf"] >= 0 and "fetch_cdf=" in timers.report()
    assert _names(profiling.drain()) == ["codec.ac_decode", "codec.fetch_cdf"]


def test_trace_and_annotate_are_gone():
    assert not hasattr(profiling, "trace") and not hasattr(profiling, "annotate")


# ---- the codec's spans ----------------------------------------------------------

CFG = dict(self_depths=(2, 1), cross_depths=(1,), embed_dim=32, num_heads=2, window_size=32,
           mlp_ratio=2.0, knn_k=4)
CODEC_SPANS = {"preprocess", "preprocess.quantize", "preprocess.octree", "preprocess.split",
               "codec.encode", "codec.decode", "codec.upload", "codec.phase1",
               "codec.phase2", "codec.expand", "codec.fetch", "rans.encode", "rans.decode"}


@pytest.fixture(scope="module")
def codec():
    model = EHEM(**CFG, static_knn=True, device="cpu")
    flax_init_(model, torch.Generator().manual_seed(0))
    return EHEMCodec(model.eval(), context_size=128)


def _sweep(codec, pts):
    """One sweep as the port's users run it: preprocess, split, encode,
    upload, decode."""
    res = preprocess_points(pts, system="cart")
    sl = split_levels(res.context, angular=False)
    stream, _, _ = codec.encode_to_stream(sl)
    codes = codec.decode(codec.new_stream_decoder(stream, len(sl.occ_stream)), sl.max_level,
                         np.array(sl.pos_mm, np.int64), angular=False,
                         level_sizes=sl.level_sizes)
    np.testing.assert_array_equal(codes, sl.occ_stream)
    return stream, sl


def _groups(sizes):
    """The rANS groups of one direction: a tiny level's one group, else its
    evens and its odds."""
    out = []
    for n in sizes:
        out += [n] if n <= EHEMCodec.TINY_UNIFORM_MAX else [(n + 1) // 2, n // 2]
    return [n for n in out if n]


def test_rans_roundtrip_opens_every_span_one_unit_a_sweep(codec):
    rng = np.random.default_rng(5)
    clouds = [rng.integers(0, 2**7, size=(1500, 3)).astype(np.float64) for _ in range(2)]
    plain = [_sweep(codec, pts)[0] for pts in clouds]
    assert not profiling.drain()["spans"]
    with profiling.recording():
        got = []
        for i, pts in enumerate(clouds):
            with profiling.unit(i):
                got.append(_sweep(codec, pts))
    rec = profiling.drain()
    assert [g[0] for g in got] == plain  # byte-identical with recording off
    for i, (_, sl) in enumerate(got):
        assert sum(n > EHEMCodec.TINY_UNIFORM_MAX for n in sl.level_sizes) >= 2
        mine = [s for s in rec["spans"] if s.unit == i]
        assert {s.name for s in mine} == CODEC_SPANS | {"codec.finish_chain"}
        # coder steps of both directions, a step per 1024 lanes of a group
        steps = sum(-(-n // rans.K_LANES) for n in _groups(sl.level_sizes))
        assert rec["counters"][i] == {"rans.steps": 2 * steps}
    assert {s.unit for s in rec["spans"]} == {0, 1}
    by = {s.id: s for s in rec["spans"]}

    def parent(s):
        return by[s.parent].name if s.parent else None

    for s in rec["spans"]:
        if s.name in ("preprocess", "preprocess.split", "codec.encode", "codec.decode",
                      "codec.upload"):
            assert parent(s) is None, s
        elif s.name.startswith("preprocess."):
            assert parent(s) == "preprocess"
        elif s.name == "rans.encode":
            assert parent(s) == "codec.finish_chain"
        elif s.name in ("codec.phase1", "codec.phase2", "codec.expand", "rans.decode"):
            assert parent(s) in ("codec.encode", "codec.decode"), s
        elif s.name == "codec.fetch":
            assert parent(s) in ("codec.finish_chain", "codec.decode"), s
    lv = [n for n in got[0][1].level_sizes if n > EHEMCodec.TINY_UNIFORM_MAX]
    n_expand = sum(s.name == "codec.expand" and s.unit == 0 for s in rec["spans"])
    assert n_expand == 2 * (len(got[0][1].level_sizes) - 1) and lv


# ---- the trainer's spans ---------------------------------------------------------


def test_prefetch_waits_are_spans():
    with profiling.recording():
        with profiling.unit("s"):
            items = list(prefetch(iter(range(3)), depth=1))
    assert items == [0, 1, 2]
    rec = profiling.drain()
    assert _names(rec) == ["train.load_wait"] * 4  # three items and the end
    assert {s.unit for s in rec["spans"]} == {"s"}


def _tiny_trainer(tmp_path):
    rng = np.random.default_rng(42)
    for i in range(2):
        pts = np.unique(rng.integers(0, 2**6, (3000, 3)), axis=0)
        ctx = gen_context(build_octree(pts))
        np.save(os.path.join(tmp_path, f"shard{i}_{ctx.shape[0]}.npy"), ctx)
    cfg = load_config("train_kitti_ehem.yaml", os.path.join(ROOT, "configs"))
    cfg.data.root = os.path.join(str(tmp_path), "*.npy")
    cfg.data.batch_size = 2
    cfg.data.context_size = cfg.model.context_size = 64
    cfg.bf16 = False
    cfg.model.swin = Config.wrap(dict(embed_dim=32, self_depths=[1, 1], cross_depths=[1],
                                      num_heads=2, window_size=16, mlp_ratio=2.0))
    ds = build_dataset(cfg)
    trainer = Trainer(cfg, steps_per_epoch=10, device="cpu")
    trainer.init_state()
    return trainer, ds.batches()


def test_train_step_parts_are_spans_and_timings_keep_their_keys(tmp_path):
    trainer, gen = _tiny_trainer(tmp_path)
    timings = {}
    trainer.train_step(next(gen), timings=timings)
    trainer.train_step(next(gen), timings=timings)
    assert set(timings) == {"forward", "backward", "update"}  # one rank: no all-reduce
    assert all(v > 0 for v in timings.values())
    assert not profiling.drain()["spans"]
    with profiling.recording():
        with profiling.unit(0):
            trainer.train_step(next(gen))
        with profiling.unit(1):
            more = {}
            trainer.train_step(next(gen), timings=more)
    rec = profiling.drain()
    parts = ["train.forward", "train.backward", "train.update"]
    assert _names(rec) == parts * 2
    assert [s.unit for s in rec["spans"]] == [0] * 3 + [1] * 3
    assert set(more) == {"forward", "backward", "update"}
    for s in rec["spans"][3:]:
        assert more[s.name.split(".")[1]] == pytest.approx((s.end_ns - s.start_ns) * 1e-9)
    assert trainer.step == 4
