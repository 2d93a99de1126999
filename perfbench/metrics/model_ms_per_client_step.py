"""Device time of the traced rounds outside the program's ``gossip`` and
``fused_kernel`` spans and the sweep kernels (the per-client gradients:
forward, remat and backward, the loss), a client-step, in ms."""

from perfbench.metrics.sweep_pair_roofline_pct import sweep_seconds


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["client_steps"]:
        return None
    d = t["device_s"]
    s = d.get("model", 0.0) + d.get("unlinked", 0.0) - sweep_seconds(t)
    return None if s <= 0 else 1e3 * s / t["client_steps"]
