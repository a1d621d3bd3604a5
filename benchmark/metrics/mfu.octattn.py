"""mfu.octattn: OctAttention's products over the window's real nodes
(closed form, harness/octattn.py; encode and decode each step every node
once) over the window's time x the card's f32 peak, in percent.
Layer: model."""

from benchmark.harness.octattn import mfu_f32


def read(record):
    flops = record.get("products", {}).get("flops")
    if not flops:
        return None
    return mfu_f32(flops, record["window_s"], record.get("chips", 1))
