"""Stochastic momentum updates (paper Sec. II-C / Algorithm 1 OPTION I & II).

Port of ``repro/core/momentum.py``.  The momentum is driven by the tracking
variable y: OPTION I (Polyak / SHB)

    nu^{t+1} = gamma nu^t + (1-gamma) y^t

OPTION II (Nesterov / SNAG)

    mu^{t+1} = gamma mu^t + (1-gamma) y^t
    nu^{t+1} = gamma mu^{t+1} + (1-gamma) y^t

gamma = 0 reduces both to vanilla (nu^{t+1} = y^t).  ``nu``, ``mu`` and
``y`` are dicts of client-stacked tensors.
"""
from __future__ import annotations

from typing import Literal

import torch

MomentumKind = Literal["polyak", "nesterov", "none"]


def momentum_update(kind: MomentumKind, gamma, nu, mu, y):
    """Return ``(nu_next, mu_next)`` for dicts of tensors ``nu, mu, y``.

    ``gamma`` may be a Python float, a 0-d tensor, or a dict of per-leaf
    tensors (the sweep path's (S, 1, ..., 1) values); the gamma == 0
    shortcut is taken for Python numbers only, as in the reference.
    """
    if kind == "none":
        return y, mu
    if isinstance(gamma, (int, float)) and gamma == 0.0:
        return y, mu

    def axpy(k, a, b):
        # gamma in the leaf's dtype: an fp32 scalar must not promote bf16
        g = torch.as_tensor(gamma[k] if isinstance(gamma, dict) else gamma,
                            dtype=a.dtype)
        return g * a + (1.0 - g) * b

    if kind == "polyak":
        return {k: axpy(k, nu[k], y[k]) for k in nu}, mu
    if kind == "nesterov":
        mu_next = {k: axpy(k, mu[k], y[k]) for k in mu}
        nu_next = {k: axpy(k, mu_next[k], y[k]) for k in mu_next}
        return nu_next, mu_next
    raise ValueError(f"unknown momentum kind {kind!r}")


def omega(gamma: float) -> float:
    """Nesterov consensus-error inflation factor (paper: omega = (1+3g)/(1-g))."""
    return (1.0 + 3.0 * gamma) / (1.0 - gamma)
