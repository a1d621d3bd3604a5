"""preprocess_ms.p50: the median over the window's sweeps of the benchmark's
host clock around the program's preprocess calls (preprocess_points +
split_levels), in milliseconds.  Layer: preprocessing."""

from benchmark.harness.common import p50


def read(record):
    v = p50(record.get("spans", {}).get("preprocess", []))
    return None if v is None else 1e3 * v
