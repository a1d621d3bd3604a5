"""position_ms.octattn: the pace of OctAttention's step loop: the program's
`octattn.level` span over the sweep's deepest level (its encode loop, coded
once more after the window under recording alone) over that loop's
`octattn.positions`, in milliseconds a lane-wide step.  None where the
program records neither.  Layer: codec."""

from benchmark.harness.program_spans import probe_spans, probe_count


def read(record):
    spans = probe_spans(record, "octattn.level", "deepest")
    n = probe_count(record, "octattn.positions", "deepest")
    if not spans or not n:
        return None
    return 1e-6 * sum(s.end_ns - s.start_ns for s in spans) / n
