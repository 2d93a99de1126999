"""The whole step's share of the chip's bf16 peak: the model's training
FLOPs of the tokens the unprofiled window completed (``counts.py``: no
recomputation) over its wall time x 989 TFLOP/s."""

from perfbench.counts import PEAK_BF16_FLOPS


def read(ctx):
    w = ctx.get("window")
    if not w or w["rounds"] == 0:
        return None
    return 100.0 * ctx["counts"]["flops_per_token"] * w["tokens"] / (
        w["wall_s"] * PEAK_BF16_FLOPS)
