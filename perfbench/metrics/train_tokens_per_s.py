"""All clients' tokens in all rounds the window completed, over the
window's wall time (host clock; the window ends in a device synchronise)."""


def read(ctx):
    w = ctx.get("window")
    if not w or w["rounds"] == 0:
        return None
    return w["tokens"] / w["wall_s"]
