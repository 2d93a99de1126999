"""Dict-of-tensors wrappers for the prox kernels.

Port of ``repro/kernels/prox/ops.py``:

* :func:`prox_tree` / :func:`fused_update_tree` run the one-config
  kernels over dicts of tensors of any shape: on the card one grouped
  launch for every leaf (per dtype), where the reference launches once a
  leaf;
* ``fused_update_sweep_tree`` / ``fused_tracking_sweep_tree`` run a sweep
  kernel over dicts of explicit ``(S, C, ...)`` leaves: on the card one
  grouped launch for every leaf (per dtype), where the reference launches
  once a leaf;
* :func:`fused_local_update` / :func:`fused_tracking` are the round
  program's entry points.  One config's ``(C, ...)`` leaves with a (5,)
  row run through the grouped launch with a single-config axis (S = 1), as
  the reference's unbatched call does; the sweep's ``(S, C, ...)`` leaves
  with an (S, 5) table run all S configs in the same one launch.  That
  stands in for the reference's ``custom_vmap`` rule, which maps a
  stacked-Hyper sweep axis onto the kernel's config axis.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.prox.kernel import (
    fused_tracking_sweep_grouped,
    fused_update_grouped,
    fused_update_sweep_grouped,
    prox_grouped,
)
from repro_torch.obs.trace import annotate


def prox_tree(tree, *, kind: str, lam, alpha, theta=4.0):
    """The prox kernel over a dict of tensors (one grouped call)."""
    keys = list(tree)
    return dict(zip(keys, prox_grouped([tree[k] for k in keys], kind=kind,
                                       lam=lam, theta=theta, alpha=alpha)))


def fused_update_tree(x_tree, y_tree, nu_tree, *, kind: str, lam, alpha,
                      gamma, theta=4.0):
    """Fused DEPOSITUM local update over dicts (one grouped call).  Returns
    (x', nu')."""
    keys = list(x_tree)
    xs, nus = fused_update_grouped(
        [x_tree[k] for k in keys], [y_tree[k] for k in keys],
        [nu_tree[k] for k in keys], kind=kind, lam=lam, theta=theta,
        alpha=alpha, gamma=gamma)
    return dict(zip(keys, xs)), dict(zip(keys, nus))


def fused_update_sweep_tree(x_tree, y_tree, nu_tree, params, mask=None, *,
                            kind: str):
    """Sweep-major fused update over dicts of (S, C, ...) leaves.

    ``params`` is the (S, 5) table, ``mask`` an optional (S, C) gate.
    Returns (x', nu').
    """
    keys = list(x_tree)
    xs, nus = fused_update_sweep_grouped(
        [x_tree[k] for k in keys], [y_tree[k] for k in keys],
        [nu_tree[k] for k in keys], params, mask, kind=kind)
    return dict(zip(keys, xs)), dict(zip(keys, nus))


def fused_tracking_sweep_tree(y_tree, g_new_tree, g_old_tree, params,
                              mask=None):
    """Sweep-major tracking axpy over dicts.  Returns (y', g_kept)."""
    keys = list(y_tree)
    ys, gs = fused_tracking_sweep_grouped(
        [y_tree[k] for k in keys], [g_new_tree[k] for k in keys],
        [g_old_tree[k] for k in keys], params, mask)
    return dict(zip(keys, ys)), dict(zip(keys, gs))


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


def _leaves(tree, keys):
    return [tree[k].contiguous() for k in keys]


def _table(hp_vec, mask):
    """(params table, gate, lead) of a round: one config's (5,) row as a
    (1, 5) table with a (1, C) gate over ``(C, ...)`` leaves (lead 1), or
    the sweep's (S, 5) table with its (S, C) gate over ``(S, C, ...)``
    leaves (lead 2)."""
    gate = None if mask is None else mask.to(torch.float32).contiguous()
    if hp_vec.ndim == 1:
        return hp_vec[None], None if gate is None else gate[None], 1
    return hp_vec, gate, 2


def fused_local_update(x_tree, y_tree, nu_tree, hp_vec, mask=None, *,
                       kind: str):
    """Momentum + prox for one config's clients, or for every config of a
    sweep: one grouped launch.

    ``hp_vec`` is the (5,) row [lam, theta, alpha, gamma, beta] (leaves
    ``(C, ...)``, ``mask`` an optional (C,) cohort gate) or the (S, 5)
    table (leaves ``(S, C, ...)``, ``mask`` (S, C)), on the leaves'
    device; the gate freezes rows in-kernel.  Returns (x', nu').
    """
    with annotate("fused_kernel"):
        keys = list(x_tree)
        params, gate, lead = _table(hp_vec, mask)
        xs, nus = fused_update_sweep_grouped(
            _leaves(x_tree, keys), _leaves(y_tree, keys),
            _leaves(nu_tree, keys), params, gate, kind=kind, lead=lead)
    return dict(zip(keys, xs)), dict(zip(keys, nus))


def fused_tracking(y_tree, g_new_tree, g_old_tree, hp_vec, mask=None):
    """Tracking axpy ``y' = y + beta (g_new - g_old)`` (+ in-kernel freeze
    when ``mask`` given) for one config's clients or a sweep's, as
    :func:`fused_local_update`.  Returns (y', g_kept)."""
    with annotate("fused_kernel"):
        keys = list(y_tree)
        params, gate, lead = _table(hp_vec, mask)
        ys, gs = fused_tracking_sweep_grouped(
            _leaves(y_tree, keys), _leaves(g_new_tree, keys),
            _leaves(g_old_tree, keys), params, gate, lead=lead)
    return dict(zip(keys, ys)), dict(zip(keys, gs))
