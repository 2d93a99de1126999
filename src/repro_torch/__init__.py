"""PyTorch/CUDA port of the DEPOSITUM reproduction.

A second package beside the JAX reference ``repro``: the same module paths
and public names, PyTorch idiom inside (``nn.Module`` models, plain
functions on tensors, dicts of ``(C, ...)`` tensors for client-stacked
parameters), and hand-written CUDA kernels for Hopper where the reference
has Pallas kernels.  Nothing here imports ``jax`` or ``repro``.
"""
from repro_torch._device import resolve_device  # noqa: F401
