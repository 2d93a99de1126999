"""The plain backward of the RMSNorm pair (the kernels' ground truth).

The plain forward is ``models/common.py::rms_norm_plain``, which the
models run on the CPU; :func:`rms_norm_bwd_ref` is its gradient written
out, in fp32, as the backward kernel computes it::

    r  = rsqrt(mean(x^2) + eps),  xh = x r,  g = (1 + w) dy
    dx = r (g - xh mean(xh g)),   dw = sum over rows of dy xh
"""
from __future__ import annotations

import torch


def rms_norm_bwd_ref(x, weight, dy, eps: float = 1e-6):
    """``(dx, dw)`` of ``rms_norm_plain`` for the output gradient ``dy``:
    fp32 throughout, dx in x's dtype and shape, dw in w's."""
    x32, dy32 = x.to(torch.float32), dy.to(torch.float32)
    r = torch.rsqrt(torch.mean(torch.square(x32), dim=-1, keepdim=True)
                    + eps)
    xh = x32 * r
    g = (1.0 + weight.to(torch.float32)) * dy32
    dx = r * (g - xh * torch.mean(xh * g, dim=-1, keepdim=True))
    dw = (dy32 * xh).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dw.to(weight.dtype)
