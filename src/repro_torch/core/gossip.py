"""Gossip mixing x <- (W ⊗ I) x over the leading client dim.

Port of the stacked-clients part of ``repro/core/gossip.py``:
:func:`identity_mixer` and :func:`make_dense_mixer`, and the dense mix of
one leaf, alone or over a sweep axis.  The dense mix is a full-fp32
matrix product (TF32 must stay off: callers on the card set
``torch.backends.cuda.matmul.allow_tf32 = False``, the PyTorch default).
The collective mixers (ring / torus / complete over a process group) come
with the backends slice.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch._device import resolve_device

Mixer = Callable[[dict], dict]


def identity_mixer(tree):
    return tree


def dense_mix_leaf(W: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``out_i = sum_j W_ij x_j`` on the leading dim of one leaf."""
    n = x.shape[0]
    return (W.to(x.dtype) @ x.reshape(n, -1)).reshape(x.shape)


def dense_mix_sweep_leaf(W: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``out_si = sum_j W_sij x_sj`` on one ``(S, n, ...)`` leaf: one
    batched full-fp32 product for all S points; ``W`` is ``(S, n, n)``
    per point or ``(n, n)`` shared."""
    S, n = x.shape[:2]
    return torch.matmul(W.to(x.dtype), x.reshape(S, n, -1)).reshape(x.shape)


def make_dense_mixer(W, *, device="cuda") -> Mixer:
    """x_i <- sum_j W_ij x_j on the leading client dim of every leaf.

    ``W`` (numpy or tensor, ``(n, n)``) is moved to ``device`` once, here,
    so the round loop does no host-to-device copy.
    """
    Wt = torch.as_tensor(W if isinstance(W, torch.Tensor) else np.asarray(W))
    Wt = Wt.to(resolve_device(device), torch.float32)

    def mix(tree):
        return {k: dense_mix_leaf(Wt, v) for k, v in tree.items()}

    return mix
