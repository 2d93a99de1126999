"""Seconds from process start to the first timed round: imports, the
kernels' build (a checkout's first run), weights, state and the first
steps, which the correctness check records."""


def read(ctx):
    return ctx.get("setup_s")
