"""Codec math (transform, intra, ME, interpolation, deblocking)."""
