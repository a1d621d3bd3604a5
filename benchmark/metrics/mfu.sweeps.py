"""mfu.sweeps: the model's products over the window's real nodes (closed
form, harness/products.py; encode and decode each run both phases) over
the window's time x the chip's bf16 peak, in percent.  Layer: model."""

from benchmark.harness.products import mfu_share


def read(record):
    flops = record.get("products", {}).get("flops")
    if not flops:
        return None
    return mfu_share(flops, record["window_s"], record.get("chips", 1))
