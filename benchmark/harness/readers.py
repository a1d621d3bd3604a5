"""What several metric readers share: a kernel family's roofline share and
the device's idle share, from a run's traces."""

from benchmark.harness import registry
from benchmark.harness.products import least_seconds


def roofline_share(record, family: str, work_key: str):
    """The least time of a kernel family's work in the traced units
    (harness/products.py) over that family's device time by kernel name
    (kernels/<family>.json), in percent.  None when the trace holds no
    kernel of the family or the units gave it no work."""
    traces = record.get("traces")
    work = (record.get("traced_products") or {}).get(work_key)
    if not traces or not work:
        return None
    patterns = registry.kernel_map(family)["patterns"]
    secs = [t.kernel_seconds(patterns) for t in traces]
    if any(s is None or s <= 0 for s in secs):
        return None
    least = sum(least_seconds(ops, nbytes) for ops, nbytes in work)
    return 100.0 * least / sum(secs)


def idle_share(record):
    """One minus the union of the device's operation intervals over the
    traced window, the mean over the cards."""
    traces = record.get("traces")
    if not traces or any(t.window_s <= 0 for t in traces):
        return None
    return sum(1.0 - t.busy_s / t.window_s for t in traces) / len(traces)
