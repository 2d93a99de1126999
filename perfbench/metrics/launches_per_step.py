"""Kernels launched on the device in the traced rounds, a DEPOSITUM step
(all clients): a count."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["steps"]:
        return None
    n = t["counts"].get("kernel", 0)
    return None if n == 0 else n / t["steps"]
