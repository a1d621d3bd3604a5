"""Native (C++) host code of the port, built with g++ and loaded via ctypes.

  build          — compiles `src/octree.cpp` and `src/ac.cpp` into
                   scp_tpu_torch/_build/.
  octree_native  — single-pass BFS octree builder from sorted Morton keys.
  ac_native      — the range coder (streaming encoder, batched decoder).

Unlike scp_tpu's, a failed build raises: the caller that asked for the
native builder never gets the numpy one instead.
"""
