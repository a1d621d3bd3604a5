"""Codec layer of the port: slicing, stream container, device rANS and
the EHEM wavefront codec (rans mode)."""
