"""mfu.train: 3 x the forward products (the model-FLOPs convention) of the
window's steps, over the window's time x the peak, in percent.  Layer: model."""

from benchmark.harness.products import mfu_share


def read(record):
    flops = record.get("products", {}).get("flops")
    if not flops:
        return None
    return mfu_share(flops, record["window_s"], record.get("chips", 1))
