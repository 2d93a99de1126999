"""Phase annotations for profiler timelines.

Port of :func:`annotate` from ``repro/obs/trace.py``: a
``torch.profiler.record_function`` range (host timeline of a
``torch.profiler`` capture) plus an NVTX range on the card, named with the
DEPOSITUM phase vocabulary below.  Timing helpers and profile capture come
with the telemetry slice.
"""
from __future__ import annotations

import contextlib

import torch

#: DEPOSITUM phase names used by the in-tree annotations.
PHASES = ("local_step", "gossip", "compress_pack", "compress_unpack",
          "fused_kernel", "telemetry")


@contextlib.contextmanager
def annotate(name: str):
    """Name a code region for profiler traces (host range + NVTX range)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
