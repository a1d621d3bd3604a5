"""Torch entropy models of the port (EHEM, inference path)."""
