"""Sweep-major DEPOSITUM update kernels (port of ``repro/kernels/prox``)."""
