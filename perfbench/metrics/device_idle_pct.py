"""Share of the traced rounds' wall time in which no kernel, copy or set
ran on the device: 100 (1 - union of device intervals / wall)."""


def read(ctx):
    t = ctx.get("trace")
    if not t or t["wall_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["wall_s"])
