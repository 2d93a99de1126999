"""The held experts' products over the device time of the kernels that
compute them: the least time of ``work/mla_moe.py::expert_flops_per_token``
(the gate, up and down products of the experts a token expects among the
held ones, forward and backward, no recompute) x ``tokens_per_client_step``
x the traced client-steps at 989 TFLOP/s, over the time of the grouped
GEMM kernels, found by name (``torch._grouped_mm``'s CUTLASS sm90 kernel,
``GroupProblemShape`` in its name, and its ``prepare_grouped_gemm_data``
set-up kernel).  The count comes from the configuration alone, so it reads
the same work whatever computes it.  Nothing where the model holds no
experts or no such kernel ran."""

import re

from perfbench.counts import PEAK_BF16_FLOPS

EXPERT_KERNELS = re.compile(r"GroupProblemShape|prepare_grouped_gemm_data")


def expert_seconds(trace) -> float:
    return sum(v for k, v in trace["by_name"].items() if EXPERT_KERNELS.search(k))


def read(ctx):
    t, m = ctx.get("trace"), ctx.get("model")
    if not t or not t["client_steps"] or not m or not m.get("experts_held"):
        return None
    spent = expert_seconds(t)
    if spent <= 0:
        return None
    from perfbench.work.mla_moe import expert_flops_per_token

    flops = expert_flops_per_token(m, ctx["traffic"]["seq_len"])
    least = (flops * ctx["counts"]["tokens_per_client_step"] * t["client_steps"]
             / PEAK_BF16_FLOPS)
    return 100.0 * least / spent
