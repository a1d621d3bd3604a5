"""idle_share.train: the share of the traced steps with no operation on the
device (torch.profiler's CUPTI trace), the mean over the cards.  Layer: device."""

from benchmark.harness.readers import idle_share


def read(record):
    return idle_share(record)
