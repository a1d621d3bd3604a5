"""The benchmark of scp_tpu_torch, the PyTorch and CUDA port (see run.py).

Everything the yardstick needs lives here: the traffic generator, the
configurations and traffic mixes as data files, the metric readers, the
kernel-name maps, the closed-form products and the H100's peaks, and the
plain reference that decides `correct`.  Nothing here imports JAX or the
JAX package.
"""
