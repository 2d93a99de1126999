"""Dict-of-tensors wrappers for the prox kernels.

Port of ``repro/kernels/prox/ops.py``:

* :func:`prox_tree` / :func:`fused_update_tree` apply the one-config
  kernels leafwise over dicts of tensors of any shape;
* ``fused_update_sweep_tree`` / ``fused_tracking_sweep_tree`` apply a
  kernel leafwise over dicts of explicit ``(S, C, ...)`` leaves;
* :func:`fused_local_update` / :func:`fused_tracking` are the round
  program's entry points.  They run one config's clients through the
  sweep-major kernel with a single-config axis (S = 1), as the reference's
  unbatched call does.  (The reference's ``custom_vmap`` rule, which maps a
  stacked-Hyper sweep axis onto the kernel's config axis, comes with the
  sweep slice: there the leaves carry ``S`` explicitly.)
"""
from __future__ import annotations

import torch

from repro_torch.kernels.prox.kernel import (
    fused_tracking_sweep_cuda,
    fused_update_cuda,
    fused_update_sweep_cuda,
    prox_cuda,
)
from repro_torch.obs.trace import annotate


def prox_tree(tree, *, kind: str, lam, alpha, theta=4.0):
    """Apply the prox kernel leafwise over a dict of tensors."""
    return {k: prox_cuda(v, kind=kind, lam=lam, theta=theta, alpha=alpha)
            for k, v in tree.items()}


def fused_update_tree(x_tree, y_tree, nu_tree, *, kind: str, lam, alpha,
                      gamma, theta=4.0):
    """Fused DEPOSITUM local update over dicts.  Returns (x', nu')."""
    xs, nus = {}, {}
    for k in x_tree:
        xs[k], nus[k] = fused_update_cuda(
            x_tree[k], y_tree[k], nu_tree[k], kind=kind, lam=lam,
            theta=theta, alpha=alpha, gamma=gamma)
    return xs, nus


def fused_update_sweep_tree(x_tree, y_tree, nu_tree, params, mask=None, *,
                            kind: str):
    """Sweep-major fused update over dicts of (S, C, ...) leaves.

    ``params`` is the (S, 5) table, ``mask`` an optional (S, C) gate.
    Returns (x', nu').
    """
    xs, nus = {}, {}
    for k in x_tree:
        xs[k], nus[k] = fused_update_sweep_cuda(
            x_tree[k], y_tree[k], nu_tree[k], params, mask, kind=kind)
    return xs, nus


def fused_tracking_sweep_tree(y_tree, g_new_tree, g_old_tree, params,
                              mask=None):
    """Sweep-major tracking axpy over dicts.  Returns (y', g_kept)."""
    ys, gs = {}, {}
    for k in y_tree:
        ys[k], gs[k] = fused_tracking_sweep_cuda(
            y_tree[k], g_new_tree[k], g_old_tree[k], params, mask)
    return ys, gs


def hyper_param_vec(hyper, *, device=None) -> torch.Tensor:
    """(5,) params row [lam, theta, alpha, gamma, beta] from a Hyper (or any
    object with those scalar attributes); stacked Hypers give (S, 5).

    With ``device`` the row is placed there: on a CUDA device through
    pinned memory without blocking, so building it once per round costs
    the stream no synchronisation.
    """
    vals = [torch.as_tensor(v, dtype=torch.float32).cpu() for v in
            (hyper.lam, hyper.theta, hyper.alpha, hyper.gamma, hyper.beta)]
    vec = torch.stack(vals, dim=-1)
    if device is None:
        return vec
    device = torch.device(device)
    if device.type == "cuda":
        return vec.pin_memory().to(device, non_blocking=True)
    return vec.to(device)


def _one(tree):
    """(C, ...) leaves as contiguous (1, C, ...) sweep views."""
    return {k: v.contiguous()[None] for k, v in tree.items()}


def _drop(tree):
    return {k: v[0] for k, v in tree.items()}


def _gate(mask):
    return None if mask is None else mask.to(torch.float32).contiguous()[None]


def fused_local_update(x_tree, y_tree, nu_tree, hp_vec, mask=None, *,
                       kind: str):
    """Momentum + prox for one config's clients (S = 1 sweep kernel).

    ``hp_vec`` is the (5,) row [lam, theta, alpha, gamma, beta] on the
    leaves' device; ``mask`` an optional (C,) cohort gate freezing rows
    in-kernel.  Returns (x', nu').
    """
    with annotate("fused_kernel"):
        xs, nus = fused_update_sweep_tree(
            _one(x_tree), _one(y_tree), _one(nu_tree), hp_vec[None],
            _gate(mask), kind=kind)
    return _drop(xs), _drop(nus)


def fused_tracking(y_tree, g_new_tree, g_old_tree, hp_vec, mask=None):
    """Tracking axpy ``y' = y + beta (g_new - g_old)`` (+ in-kernel freeze
    when ``mask`` given) for one config's clients.  Returns (y', g_kept)."""
    with annotate("fused_kernel"):
        ys, gs = fused_tracking_sweep_tree(
            _one(y_tree), _one(g_new_tree), _one(g_old_tree), hp_vec[None],
            _gate(mask))
    return _drop(ys), _drop(gs)
