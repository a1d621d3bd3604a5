"""CUDA graph capture for the port's replayed loops.

`capture(fn)` records what fn() launches on the current device as one
CUDA graph; `graph.replay()` then relaunches all of it in one call.  A
graph reads and writes the memory its capture saw, so whatever fn reads
or writes must stay allocated, at the same address, for as long as the
graph is replayed: the callers keep those tensors as static buffers and
copy new values into them.
"""

from __future__ import annotations

import torch


def capture(fn):
    """fn() captured as a CUDA graph on the current device: one run first,
    outside the capture (library handles, workspaces, a kernel's build),
    then the capture.  Returns (graph, what the captured fn returned)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out
