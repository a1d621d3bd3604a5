"""step_ms.p50: the median over the window's training steps of the
benchmark's host clock per step (Trainer.train_step, ending in a
synchronise), in milliseconds; rank 0's.  Layer: trainer."""

from benchmark.harness.common import p50


def read(record):
    v = p50(record.get("spans", {}).get("step", []))
    return None if v is None else 1e3 * v
