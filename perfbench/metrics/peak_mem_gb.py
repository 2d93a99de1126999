"""``torch.cuda.max_memory_allocated()`` over set-up and window, after
``reset_peak_memory_stats()`` at process start, in GB (1e9 bytes)."""


def read(ctx):
    peak = ctx.get("peak_bytes")
    return None if peak is None else peak / 1e9
