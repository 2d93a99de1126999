"""The model's attention work over the device time of the program's bf16
flash kernels: the least time of ``counts.attention_flops_per_token`` x
``tokens_per_client_step`` x the traced client-steps at 989 TFLOP/s (12 D
FLOPs a visible (query, key) pair and head: forward 4 D, backward 8 D;
neither the forward's second pass under remat nor the backward's
recompute of the scores counts) over the time of the forward (with its
row logsumexp) and the backward's three kernels, found by name
(``kernels/flash_attention/csrc/flash_fwd_sm90.cu``, ``flash_bwd_sm90.cu``;
their ctypes launches leave the profiler no launch record to tie them to a
span).  Nothing where no flash kernel ran."""

import re

from perfbench.counts import PEAK_BF16_FLOPS

FLASH_KERNELS = re.compile(r"\bflash_(fwd_sm90|bwd_delta|bwd_dkdv|bwd_dq)_kernel\b")


def flash_seconds(trace) -> float:
    return sum(v for k, v in trace["by_name"].items() if FLASH_KERNELS.search(k))


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["client_steps"]:
        return None
    spent = flash_seconds(t)
    if spent <= 0:
        return None
    c = ctx["counts"]
    least = (c["attention_flops_per_token"] * c["tokens_per_client_step"]
             * t["client_steps"] / PEAK_BF16_FLOPS)
    return 100.0 * least / spent
