"""decode_ms.p50: the median over the window's sweeps of the benchmark's
host clock around the program's decode calls (new_stream_decoder + decode, ending in
a synchronise), in milliseconds.  Layer: codec."""

from benchmark.harness.common import p50


def read(record):
    v = p50(record.get("spans", {}).get("decode", []))
    return None if v is None else 1e3 * v
