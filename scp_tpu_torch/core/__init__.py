"""Numpy geometry host code (copies of scp_tpu/core, numpy paths only)."""
