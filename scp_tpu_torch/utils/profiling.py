"""Tracing / profiling utilities (the twin of scp_tpu/utils/profiling.py).

  * StageTimers — named wall-clock accumulators with a report line (the
    codec's `timers`: its host stages, dispatch, fetch and coder);
  * trace(dir) — a torch.profiler trace of the host and the card, written
    as a Chrome trace into `dir`;
  * annotate(name) — a named range (record_function) in that trace.

scp_tpu turns its trace on with SCP_TRACE_DIR; here the caller passes the
directory.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


class StageTimers:
    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def clear(self) -> None:
        self.totals.clear()
        self.counts.clear()

    def report(self) -> str:
        parts = [
            f"{k}={v:.3f}s/{self.counts[k]}" for k, v in sorted(self.totals.items())
        ]
        return " ".join(parts)


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """A torch.profiler trace (host and, when there is a card, CUDA
    activity) written to `log_dir/trace.json`; nothing when no directory
    is given."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    from torch.profiler import record_function

    return record_function(name)
