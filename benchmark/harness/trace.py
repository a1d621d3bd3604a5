"""The device trace of a run: torch.profiler (CUPTI) over whole units,
reduced to what the per-layer readers and the result's breakdown need.

busy_s is the union of the intervals in which any operation (kernel,
copy, fill) ran on the card, clipped to the traced window; the idle share
is one minus busy over the window.  Idle gaps are labelled by what the
host was doing: the benchmark's own range around the call (`bench.*`)
and the last operator the host had begun before the gap ended.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

WINDOW_LABEL = "bench.traced"


class Trace:
    """kernels: [(name, start_s, end_s)] relative to the window's start;
    host: [(name, start_s, end_s)] of the benchmark's ranges; ops: [(name,
    start_s)] of the host's operators; window_s."""

    def __init__(self, kernels, host, ops, window_s):
        self.kernels = sorted(kernels, key=lambda k: k[1])
        self.host = host
        self.ops = sorted(ops, key=lambda o: o[1])
        self.window_s = window_s

    def busy_intervals(self):
        out = []
        for _, s, e in self.kernels:
            s, e = max(s, 0.0), min(e, self.window_s)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def kernel_seconds(self, patterns) -> float | None:
        """Summed device time of the kernels whose name matches any pattern;
        None when none does."""
        rx = [re.compile(p) for p in patterns]
        hit = [e - s for name, s, e in self.kernels if any(r.search(name) for r in rx)]
        return sum(hit) if hit else None

    def top_ops(self, n: int = 10) -> list:
        by = defaultdict(float)
        for name, s, e in self.kernels:
            by[name] += e - s
        return [[k[:200], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle time summed by what the host was doing: [label, seconds]."""
        by = defaultdict(float)
        starts = [o[1] for o in self.ops]
        prev = 0.0
        for s, e in self.busy_intervals() + [[self.window_s, self.window_s]]:
            if s > prev:
                by[self._label(prev, s, starts)] += s - prev
            prev = max(prev, e)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def _label(self, a, b, starts) -> str:
        mid = 0.5 * (a + b)
        inner = [h for h in self.host if h[1] <= mid <= h[2]]
        stage = min(inner, key=lambda h: h[2] - h[1])[0] if inner else "outside"
        i = bisect.bisect_right(starts, b) - 1
        op = self.ops[i][0] if i >= 0 else "none"
        return f"{stage} / {op}"[:200]


def capture(fn, device_index=None):
    """Run fn() under torch.profiler inside the range WINDOW_LABEL (the
    caller synchronizes inside fn) and reduce the events to a Trace of the
    card `device_index` (None: every card of the process)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(WINDOW_LABEL):
            fn()
        if cuda:
            torch.cuda.synchronize()
    return reduce_events(_events(prof), device_index)


def _events(prof):
    return events_of(prof.profiler.kineto_results.events())


def events_of(kineto_events):
    """(name, is_device, device index, start_ns, end_ns) of every event;
    is_device marks work on the card (kernels, copies, fills), not the
    annotations the profiler mirrors onto the card's timeline."""
    out = []
    for e in kineto_events:
        dev = str(e.device_type()).endswith("CUDA")
        if dev and _is_annotation(e):
            continue
        start = e.start_ns()
        out.append((e.name(), dev, e.device_index(), start, start + e.duration_ns()))
    return out


def _is_annotation(e) -> bool:
    """Whether a profiler event is a range annotation rather than work; the
    event's methods differ between PyTorch releases."""
    if hasattr(e, "is_user_annotation"):
        return bool(e.is_user_annotation())
    if hasattr(e, "activity_type"):
        return "annotation" in str(e.activity_type()).lower()
    return False


def reduce_events(events, device_index=None) -> Trace:
    win = [(s, e) for name, dev, _, s, e in events if not dev and name == WINDOW_LABEL]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW_LABEL} range")
    w0, w1 = win[0]
    kernels, host, ops = [], [], []
    for name, dev, idx, s, e in events:
        rel = ((s - w0) * 1e-9, (e - w0) * 1e-9)
        if dev:
            if name.startswith("bench."):
                continue
            if device_index is None or idx == device_index:
                kernels.append((name, *rel))
        elif name.startswith("bench.") and name != WINDOW_LABEL:
            host.append((name, *rel))
        elif w0 <= s <= w1:
            ops.append((name, rel[0]))
    return Trace(kernels, host, ops, (w1 - w0) * 1e-9)


def breakdown(traces) -> dict:
    """The result line's breakdown from one trace per card: the device
    operations that took most time and the longest idle gaps, summed over
    the cards."""
    ops, gaps = defaultdict(float), defaultdict(float)
    for t in traces:
        for k, v in t.top_ops(50):
            ops[k] += v
        for k, v in t.idle_gaps(50):
            gaps[k] += v
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}
