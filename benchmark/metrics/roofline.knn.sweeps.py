"""roofline.knn.sweeps: kernel D: the least time of its work (the
brute-force score products, each input byte read once) in the traced
sweeps over its device time.  Layer: KNN graph."""

from benchmark.harness.readers import roofline_share


def read(record):
    return roofline_share(record, "knn", "knn")
