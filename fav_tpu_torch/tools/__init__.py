"""Measurement tools of the port: the packed-kernel A/B (``ab_packed_kernels``)."""
