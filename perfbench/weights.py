"""Initial weights of a configuration, made on the device from the seed.

One ``torch.Generator`` on the device fills one buffer with N(0, 1) in the
configuration's dtype (a single call for every "normal" leaf); each such
leaf is a view of it, scaled in place; the norm scales are zeros.  The
same seed gives the same weights, so the reference makes them again after
the program's run.
"""
from __future__ import annotations

import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_weights(specs, seed: int, device, dtype: str) -> dict:
    """name -> tensor for every leaf of ``specs`` (``(name, shape, init,
    scale)``), drawn from ``seed`` on ``device``."""
    dt = DTYPES[dtype]
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    total = sum(math.prod(s[1]) for s in specs if s[2] == "normal")
    buf = torch.empty(total, dtype=dt, device=device).normal_(generator=gen)
    out, off = {}, 0
    for name, shape, init, scale in specs:
        if init == "normal":
            n = math.prod(shape)
            out[name] = buf[off:off + n].view(shape).mul_(scale)
            off += n
        elif init == "zeros":
            out[name] = torch.zeros(shape, dtype=dt, device=device)
        else:
            raise ValueError(f"unknown init {init!r}")
    return out
