"""peak_mem_gib.train: torch.cuda.max_memory_allocated of the fullest rank
over set-up and window, in GiB.  Layer: device."""


def read(record):
    peak = record.get("memory_peak_bytes")
    return None if not peak else peak / 2 ** 30
