"""What the readers of the program's own spans and counters share: the
drained recordings (utils/profiling.py's `drain()`) a runner keeps in its
record.  Every function returns None, never raises, where the program
recorded nothing, as a program without these spans does."""

from __future__ import annotations


def probe_spans(record, name: str, unit) -> list:
    """Spans `name` of unit `unit` in the record's probe recording."""
    probe = record.get("probe") or {}
    return [s for s in probe.get("spans", []) if s.name == name and s.unit == unit]


def probe_count(record, name: str, unit):
    probe = record.get("probe") or {}
    return (probe.get("counters") or {}).get(unit, {}).get(name)

