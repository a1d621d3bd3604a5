"""graph_share.octattn: how often OctAttention's captured position step
engages: the program's `octattn.graph_replays` (positions whose model step
ran as a CUDA graph replay) over `octattn.positions`, both counted over the
sweep's deepest level's encode loop coded after the window under recording
(unit "deepest").  1.0 where every position replays; None where the
program counts no replays (a program without the graphs, or the CPU).
Layer: codec."""

from benchmark.harness.program_spans import probe_count


def read(record):
    replays = probe_count(record, "octattn.graph_replays", "deepest")
    n = probe_count(record, "octattn.positions", "deepest")
    if not replays or not n:
        return None
    return replays / n
