"""roofline.swin.sweeps: kernels A, B and C together: the least time of
their work in the traced sweeps over their device time.  Layer: Swin
kernels."""

from benchmark.harness.readers import roofline_share


def read(record):
    return roofline_share(record, "swin", "swin")
