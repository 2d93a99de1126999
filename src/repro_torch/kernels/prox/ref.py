"""Plain PyTorch oracles for the fused proximal operators (kernel ground truth).

Port of ``repro/kernels/prox/ref.py``.  The scalars may be Python floats or
tensors that broadcast against ``x`` (the sweep kernels' plain versions pass
``(S, 1, 1)`` columns of the hyperparameter table).
"""
from __future__ import annotations

import torch


def soft_threshold(x, thr):
    return torch.sign(x) * torch.clamp_min(torch.abs(x) - thr, 0.0)


def prox_l1_ref(x, lam, alpha):
    return soft_threshold(x, alpha * lam)


def prox_mcp_ref(x, lam, theta, alpha):
    a = torch.abs(x)
    shrunk = soft_threshold(x, alpha * lam) / (1.0 - alpha / theta)
    out = torch.where(a <= theta * lam, shrunk, x)
    return torch.where(a <= alpha * lam, torch.zeros_like(x), out)


def prox_scad_ref(x, lam, theta, alpha):
    a = torch.abs(x)
    r1 = soft_threshold(x, alpha * lam)
    r2 = ((theta - 1.0) * x - torch.sign(x) * theta * lam * alpha) / (
        theta - 1.0 - alpha
    )
    return torch.where(a <= (1.0 + alpha) * lam, r1,
                       torch.where(a <= theta * lam, r2, x))


def prox_ref(x, kind: str, lam, theta, alpha):
    """Elementwise prox of ``kind`` in l1 | mcp | scad."""
    if kind == "l1":
        return prox_l1_ref(x, lam, alpha)
    if kind == "mcp":
        return prox_mcp_ref(x, lam, theta, alpha)
    if kind == "scad":
        return prox_scad_ref(x, lam, theta, alpha)
    raise ValueError(kind)


def fused_update_ref(x, y, nu, lam, alpha, gamma, prox_kind: str = "l1",
                     theta=4.0):
    """DEPOSITUM local update fused: Polyak momentum + prox descent.

        nu' = gamma * nu + (1 - gamma) * y
        x'  = prox_{alpha h}(x - alpha * nu')

    Returns (x', nu').
    """
    nu_next = gamma * nu + (1.0 - gamma) * y
    shifted = x - alpha * nu_next
    return prox_ref(shifted, prox_kind, lam, theta, alpha), nu_next
