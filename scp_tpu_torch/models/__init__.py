"""Torch entropy models of the port (EHEM: codec inference and training)."""
