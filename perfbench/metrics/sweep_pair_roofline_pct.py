"""The sweep pair's byte bound (momentum + prox: read x, y, nu, write x',
nu'; tracking: read y, g_new, g_old, write y': ``counts.sweep_pair_bytes``
at 3.35 TB/s) over the device time of the program's two sweep kernels,
found by name (``kernels/prox/csrc/prox_sweep.cu``; their ctypes
launches leave the profiler no launch record to tie them to a span)."""

import re

from perfbench.counts import HBM_BYTES_PER_S

SWEEP_KERNELS = re.compile(r"\b(fused_update_kernel|tracking_kernel)<")


def sweep_seconds(trace) -> float:
    return sum(v for k, v in trace["by_name"].items() if SWEEP_KERNELS.search(k))


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["steps"]:
        return None
    spent = sweep_seconds(t)
    if spent <= 0:
        return None
    least = ctx["counts"]["sweep_bytes"] * t["steps"] / HBM_BYTES_PER_S
    return 100.0 * least / spent
