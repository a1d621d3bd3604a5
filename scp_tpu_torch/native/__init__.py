"""Native (C++) host code of the port, built with g++ and loaded via ctypes.

  build           — compiles `src/ac.cpp`, `src/octree.cpp` and
                    `src/metrics.cpp` into scp_tpu_torch/_build/.
  octree_native   — single-pass BFS octree builder from sorted Morton keys.
  ac_native       — the range coder (streaming encoder, batched decoder).
  metrics_native  — KD-tree D1/D2 errors, mean NN distance and k-NN.

Unlike scp_tpu's, a failed build raises: the caller that asked for the
native code never gets the numpy or scipy path instead.
"""
