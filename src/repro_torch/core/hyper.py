"""Continuous DEPOSITUM hyperparameters as a NamedTuple of 0-d tensors.

Port of ``repro/core/hyper.py``.  Structure (momentum kind, prox family,
T0, fused flag) stays on :class:`~repro_torch.core.depositum.
DepositumConfig`; the continuous values live here as 0-d float32 CPU
tensors, so host-side range checks read them without a device sync.  The
fused kernels receive them as one ``(S, 5)`` device table built once per
round (:func:`repro_torch.kernels.prox.ops.hyper_param_vec`).

Fields (paper notation):
  alpha — prox-descent step size
  beta  — gradient-tracking step size (Remark 1)
  gamma — momentum coefficient in [0, 1)
  lam   — regulariser strength (radius for the box family)
  theta — MCP/SCAD knee parameter (ignored by other families)
"""
from __future__ import annotations

import itertools
from typing import NamedTuple, Sequence

import torch

Scalar = torch.Tensor  # 0-d (or sweep-stacked 1-d) float32


def _scalar(v) -> Scalar:
    return torch.as_tensor(v, dtype=torch.float32)


class Hyper(NamedTuple):
    """Continuous DEPOSITUM hyperparameters (0-d float32 tensors)."""

    alpha: Scalar
    beta: Scalar
    gamma: Scalar
    lam: Scalar
    theta: Scalar

    @classmethod
    def create(cls, alpha=0.05, beta=1.0, gamma=0.8, lam=1e-4,
               theta=4.0) -> "Hyper":
        return cls(*map(_scalar, (alpha, beta, gamma, lam, theta)))

    def replace(self, **kw) -> "Hyper":
        return self._replace(**{k: _scalar(v) for k, v in kw.items()})


def stack_hypers(hypers: Sequence[Hyper]) -> Hyper:
    """Stack a list of Hypers on a new leading sweep axis."""
    if not hypers:
        raise ValueError("need at least one Hyper to stack")
    return Hyper(*(torch.stack(vs) for vs in zip(*hypers)))


def hyper_grid(base: "Hyper | None" = None, **axes) -> Hyper:
    """Cartesian-product grid as a stacked Hyper (row-major over ``axes``).

    Fields not named in ``axes`` come from ``base`` (default
    :meth:`Hyper.create`'s values).
    """
    anchor = Hyper.create() if base is None else base
    names = list(axes)
    points = [
        anchor.replace(**dict(zip(names, combo)))
        for combo in itertools.product(*(axes[n] for n in names))
    ]
    return stack_hypers(points)


def n_sweep(hyper: Hyper) -> int:
    """Sweep-axis length (1 for an unstacked Hyper)."""
    leaf = hyper.alpha
    return 1 if leaf.ndim == 0 else int(leaf.shape[0])
