"""idle_share.sweeps: the share of the traced sweeps with no operation on the
device (torch.profiler's CUPTI trace).  Layer: device."""

from benchmark.harness.readers import idle_share


def read(record):
    return idle_share(record)
