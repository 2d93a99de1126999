"""The gossip steps' least time at 3.35 TB/s (the mixed x and y, each leaf
read once and written once in the state's dtype: ``counts.gossip_bytes``)
over the device time inside the program's ``gossip`` spans."""

from perfbench.counts import HBM_BYTES_PER_S


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["comm_steps"]:
        return None
    spent = t["device_s"].get("gossip", 0.0)
    if spent <= 0:
        return None
    least = ctx["counts"]["gossip_bytes"] * t["comm_steps"] / HBM_BYTES_PER_S
    return 100.0 * least / spent
