"""Codec layer of the port: slicing, stream container, device rANS, the
staged CDF factorization, and the EHEM (rans, staged, full) and
OctAttention codecs."""
