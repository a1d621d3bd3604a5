"""launches_per_position.octattn: the operations the card ran (kernels,
copies, fills) in the traced encode loop of the sweep's deepest level, over
that loop's `octattn.positions`.  None where the program counts no
positions or nothing was traced.  Layer: codec."""

from benchmark.harness.program_spans import probe_count


def read(record):
    traces = record.get("traces")
    n = probe_count(record, "octattn.positions", "traced")
    if not traces or not n:
        return None
    return len(traces[0].kernels) / n
