"""The program's ``cast_bytes`` counter over the traced rounds: bytes read
plus written by the model's explicit floating dtype conversions that
change the dtype (forward and remat recompute; autograd's backward casts
are not counted), a client-step, in GB (1e9 bytes)."""

from perfbench import spans


def read(ctx):
    v = spans.counter(ctx, "cast_bytes")
    return None if v is None else v / 1e9
