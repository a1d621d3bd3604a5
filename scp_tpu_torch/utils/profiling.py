"""Spans and counters of the port's host work, and the codec's stage timers.

A span names one call or loop of host work (never a single coder step); a
counter adds up work of the current unit; a unit (a sweep, a training
step) tags every span and counter opened inside it.  Recording is off
until a caller turns it on in code:

    from scp_tpu_torch.utils import profiling

    with profiling.recording():
        with profiling.unit(0):
            ...                       # the port's work
    rec = profiling.drain()           # {"spans": [Span, ...], "counters": {unit: {name: n}}}

Off, `span(name)` and `unit(id)` return one shared no-op object after a
single module-global read (no clock read, no allocation, no profiler
range) and `count` returns at once.  On, a span keeps (name, id, parent
id, unit, start_ns, end_ns) from time.perf_counter_ns(), and while a
torch.profiler is active it also opens record_function("scp." + name):
the span then lies on the device trace's clock beside the kernels,
copies and fills issued inside it.

The spans and counters the port opens, and what each is for:

  preprocess (preprocess_points), preprocess.quantize (grid + unique),
  preprocess.octree (build_octree + gen_context), preprocess.split
  (split_levels, a root of its own);
  codec.encode, codec.decode (EHEMCodec.encode_to_stream / decode),
  codec.upload (the rANS decoder's stream upload), codec.phase1,
  codec.phase2 (each phase call), codec.expand (each device expansion),
  codec.fetch (each blocking device-to-host read of the rans path);
  rans.encode (RansEncoder.finish's encode chain, up to its first fetch),
  rans.decode (each RansDecoder.decode_group); the counters rans.steps
  (coder steps enqueued, both directions: once per chunk on the CPU's
  plain loops, once per group or stream on the card) and rans.launches
  (the coder's kernel launches, one per group decoded and per stream
  encoded on the card);
  octattn.encode, octattn.decode (OctAttentionCodec.encode_incremental_into
  / decode_incremental_rans, one per direction), octattn.level (each level's
  step loop of the rans schedule, ending with a device sync: the loop's
  device time, which sets its pace on the card), octattn.fetch (each blocking
  device-to-host read of that schedule: a level's symbols, finish()'s
  three); the counters octattn.positions (lane-wide steps),
  octattn.lanes (lanes stepped, padded lanes included),
  octattn.graph_replays (positions whose model step ran as a CUDA graph
  replay; never counted on the CPU) and octattn.graph_captures (graphs
  captured: the model's step and insert, the codec's gather and post);
  train.load_wait (the consumer's wait in train/data.py:prefetch),
  train.forward, train.backward, train.allreduce, train.update
  (Trainer.train_step);
  codec.<stage> of the staged / full modes' StageTimers (dispatch_p1,
  fetch_cdf, ac_decode, ...).

StageTimers (`EHEMCodec.timers`) and Trainer.train_step(timings=...)
time through `timed` spans, which read the clock whether or not
recording is on and hand their seconds to the caller; under recording
they are recorded like any other span.
"""

from __future__ import annotations

import functools
import itertools
import sys
import time
from collections import defaultdict, namedtuple
from contextlib import contextmanager

# the prefix of a span's range in a torch.profiler trace
PROFILER_PREFIX = "scp."

Span = namedtuple("Span", "name id parent unit start_ns end_ns")
Span.__doc__ = """A closed span: parent 0 for a root; unit None outside any unit."""


class _Noop:
    """The shared no-op span and unit of recording off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Recording:
    """What one recording() block keeps while it is on: span ids, the open
    spans (for the parent ids) and the current unit.  The port opens its
    spans and counts from one thread."""

    def __init__(self):
        self.ids = itertools.count(1)
        self.stack = []
        self.unit = None


_ON: _Recording | None = None  # the recording in force, or None
_SPANS: list = []  # closed spans, until drain()
_COUNTERS: dict = {}  # {unit: {name: n}}, until drain()


class _Span:
    __slots__ = ("name", "rec", "sink", "id", "parent", "unit", "t0", "rf")

    def __init__(self, name: str, rec, sink=None):
        self.name, self.rec, self.sink, self.rf = name, rec, sink, None

    def __enter__(self):
        rec = self.rec
        if rec is not None:
            self.parent = rec.stack[-1].id if rec.stack else 0
            self.id = next(rec.ids)
            self.unit = rec.unit
            rec.stack.append(self)
            torch = sys.modules.get("torch")  # no torch loaded, no profiler running
            if torch is not None and torch.autograd._profiler_enabled():
                self.rf = torch.profiler.record_function(PROFILER_PREFIX + self.name)
                self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        rec = self.rec
        if rec is not None:
            if self.rf is not None:
                self.rf.__exit__(*exc)
            rec.stack.pop()
            _SPANS.append(Span(self.name, self.id, self.parent, self.unit, self.t0, t1))
        if self.sink is not None:
            self.sink((t1 - self.t0) * 1e-9)
        return False


class _Unit:
    __slots__ = ("rec", "uid", "prev")

    def __init__(self, rec, uid):
        self.rec, self.uid = rec, uid

    def __enter__(self):
        self.prev, self.rec.unit = self.rec.unit, self.uid
        return self

    def __exit__(self, *exc):
        self.rec.unit = self.prev
        return False


def span(name: str):
    """A span around a call or a loop; the shared no-op while recording is off."""
    rec = _ON
    if rec is None:
        return NOOP
    return _Span(name, rec)


def timed(name: str, sink):
    """A span that reads the clock whether or not recording is on and calls
    sink(seconds) when it closes (recorded too while recording is on)."""
    return _Span(name, _ON, sink)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` of the current unit (nothing while off)."""
    rec = _ON
    if rec is None:
        return
    c = _COUNTERS.setdefault(rec.unit, {})
    c[name] = c.get(name, 0) + n


def on() -> bool:
    """Whether recording is on (a caller may then pay for a truer span)."""
    return _ON is not None


def unit(uid):
    """Tag every span and counter opened inside with `uid` (a sweep, a step)."""
    rec = _ON
    if rec is None:
        return NOOP
    return _Unit(rec, uid)


@contextmanager
def recording():
    """Record spans and counters inside the block (nested blocks share the
    outer one's recording)."""
    global _ON
    if _ON is not None:
        yield
        return
    _ON = _Recording()
    try:
        yield
    finally:
        _ON = None


def drain() -> dict:
    """{"spans": [Span, ...] in closing order, "counters": {unit: {name:
    n}}} recorded so far; clears them."""
    global _SPANS, _COUNTERS
    out = {"spans": _SPANS, "counters": _COUNTERS}
    _SPANS, _COUNTERS = [], {}
    return out


class StageTimers:
    """Named wall-clock totals with a report line: the staged / full coding
    modes' host stages (EHEMCodec.timers), each a span `codec.<stage>`."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    def stage(self, name: str):
        return timed("codec." + name, functools.partial(self._add, name))

    def _add(self, name: str, seconds: float) -> None:
        self.totals[name] += seconds
        self.counts[name] += 1

    def clear(self) -> None:
        self.totals.clear()
        self.counts.clear()

    def report(self) -> str:
        parts = [
            f"{k}={v:.3f}s/{self.counts[k]}" for k, v in sorted(self.totals.items())
        ]
        return " ".join(parts)
