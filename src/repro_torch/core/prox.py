"""Proximal operators for the composite term h in phi = f + h.

Port of ``repro/core/prox.py``.  The paper's update is
``prox_h^{alpha^{-1}}{x - alpha * nu}``, i.e. the textbook
``prox_{alpha h}(x - alpha nu)`` with step size ``alpha``; validity for a
rho-weakly convex h needs ``alpha * rho < 1``.

Two layers, as in the reference:

* :class:`ProxFamily` — the parametric form ``prox_fn(x, alpha, lam,
  theta)`` / ``value_fn(x, lam, theta)``; the scalars may be Python floats
  or (0-d or broadcastable) tensors.
* :class:`ProxOperator` — the classic bound form (``make_l1(lam)`` etc.).

All maps are elementwise (separable) apart from ``group_l2``'s row norms.
Range checks run on the host: every value in eager PyTorch is concrete.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


def host_array(v) -> np.ndarray:
    """``v`` (Python number, array or tensor on any device) as numpy."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def host_min(v) -> float:
    return float(np.min(host_array(v)))


def host_max(v) -> float:
    return float(np.max(host_array(v)))


# ---------------------------------------------------------------------------
# Parametric families
# ---------------------------------------------------------------------------

def soft_threshold(x, thr):
    return torch.sign(x) * torch.clamp_min(torch.abs(x) - thr, 0.0)


@dataclasses.dataclass(frozen=True)
class ProxFamily:
    """A separable regulariser family h(.; lam, theta).

    ``rho_fn(theta)`` is the weak-convexity modulus; ``check_params(lam,
    theta)`` raises on out-of-domain parameters.
    """

    name: str
    value_fn: Callable
    prox_fn: Callable
    rho_fn: Callable = lambda theta: 0.0
    check_params: Callable = lambda lam, theta: None

    def prox(self, tree: dict, alpha, lam, theta) -> dict:
        # compute at the scalars' (fp32) precision, return the leaf's dtype
        return {k: self.prox_fn(v, alpha, lam, theta).to(v.dtype)
                for k, v in tree.items()}

    def value(self, tree: dict, lam, theta) -> torch.Tensor:
        return sum(torch.sum(self.value_fn(v, lam, theta))
                   for v in tree.values())


def _l1_value(x, lam, theta):
    return lam * torch.abs(x)


def _l1_prox(x, alpha, lam, theta):
    return soft_threshold(x, alpha * lam)


def _l2sq_value(x, lam, theta):
    return 0.5 * lam * torch.square(x)


def _l2sq_prox(x, alpha, lam, theta):
    return x / (1.0 + alpha * lam)


def _box_value(x, lam, theta):
    # 0 inside, +inf outside; for metrics report 0 (feasible iterates).
    return torch.zeros_like(x)


def _box_prox(x, alpha, lam, theta):
    # ``lam`` plays the radius role for the box family.
    lam = torch.as_tensor(lam, dtype=x.dtype, device=x.device)
    return torch.clamp(x, -lam, lam)


def _group_l2_value(x, lam, theta):
    if x.ndim < 2:
        return lam * torch.abs(x)
    norms = torch.linalg.vector_norm(x.reshape(x.shape[0], -1), dim=-1)
    return lam * norms


def _group_l2_prox(x, alpha, lam, theta):
    if x.ndim < 2:
        return soft_threshold(x, alpha * lam)
    flat = x.reshape(x.shape[0], -1)
    norms = torch.linalg.vector_norm(flat, dim=-1, keepdim=True)
    scale = torch.clamp_min(
        1.0 - alpha * lam / torch.clamp_min(norms, 1e-12), 0.0)
    return (flat * scale).reshape(x.shape)


def _mcp_value(x, lam, theta):
    a = torch.abs(x)
    inner = lam * a - torch.square(x) / (2.0 * theta)
    outer = 0.5 * theta * lam * lam
    return torch.where(a <= theta * lam, inner, outer)


def _mcp_prox(x, alpha, lam, theta):
    """Firm thresholding (requires theta > alpha):
        |x| <= alpha lam            -> 0
        alpha lam < |x| <= theta lam-> (x - alpha lam sign(x)) / (1 - alpha/theta)
        |x| > theta lam             -> x
    """
    a = torch.abs(x)
    shrunk = soft_threshold(x, alpha * lam) / (1.0 - alpha / theta)
    out = torch.where(a <= theta * lam, shrunk, x)
    return torch.where(a <= alpha * lam, torch.zeros_like(x), out)


def _scad_value(x, lam, theta):
    a = torch.abs(x)
    r1 = lam * a
    r2 = (2.0 * theta * lam * a - torch.square(x) - lam * lam) / (
        2.0 * (theta - 1.0))
    r3 = torch.full_like(x, 1.0) * (lam * lam * (theta + 1.0) / 2.0)
    return torch.where(a <= lam, r1, torch.where(a <= theta * lam, r2, r3))


def _scad_prox(x, alpha, lam, theta):
    """SCAD prox (alpha rho < 1):
        |x| <= (1+alpha) lam      -> soft(x, alpha lam)
        (1+alpha) lam < |x| <= theta lam
                                  -> ((theta-1) x - sign(x) theta lam alpha)
                                     / (theta - 1 - alpha)
        |x| > theta lam           -> x
    """
    a = torch.abs(x)
    r1 = soft_threshold(x, alpha * lam)
    r2 = ((theta - 1.0) * x - torch.sign(x) * theta * lam * alpha) / (
        theta - 1.0 - alpha)
    return torch.where(a <= (1.0 + alpha) * lam, r1,
                       torch.where(a <= theta * lam, r2, x))


def _check_mcp(lam, theta):
    # ``theta`` may be scalar or a stacked sweep axis; check the worst point
    if host_min(theta) <= 0:
        raise ValueError("MCP needs theta > 0")


def _check_scad(lam, theta):
    if host_min(theta) <= 2:
        raise ValueError("SCAD needs theta > 2")


FAMILIES: dict[str, ProxFamily] = {
    "l1": ProxFamily("l1", _l1_value, _l1_prox),
    "l2sq": ProxFamily("l2sq", _l2sq_value, _l2sq_prox),
    "box": ProxFamily("box", _box_value, _box_prox),
    "group_l2": ProxFamily("group_l2", _group_l2_value, _group_l2_prox),
    "mcp": ProxFamily("mcp", _mcp_value, _mcp_prox,
                      rho_fn=lambda theta: 1.0 / theta,
                      check_params=_check_mcp),
    "scad": ProxFamily("scad", _scad_value, _scad_prox,
                       rho_fn=lambda theta: 1.0 / (theta - 1.0),
                       check_params=_check_scad),
    "zero": ProxFamily("zero",
                       lambda x, lam, theta: torch.zeros_like(x),
                       lambda x, alpha, lam, theta: x),
}


def get_family(name: str) -> ProxFamily:
    if name not in FAMILIES:
        raise KeyError(f"unknown regulariser {name!r}; have {sorted(FAMILIES)}")
    return FAMILIES[name]


def prox_apply(name: str, tree: dict, alpha, lam=0.0, theta=4.0) -> dict:
    """``prox_{alpha h(.; lam, theta)}`` leafwise over a dict of tensors."""
    return get_family(name).prox(tree, alpha, lam, theta)


def family_params(name: str, kwargs: dict) -> tuple:
    """Map a prox_kwargs dict to the family's (lam, theta) slots."""
    if name == "box":
        return kwargs.get("radius", 1.0), 4.0
    return kwargs.get("lam", 0.0), kwargs.get("theta", 4.0)


# ---------------------------------------------------------------------------
# Bound operators (classic API)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ProxOperator:
    """A separable regulariser h with its proximal map (parameters bound)."""

    name: str
    value_fn: Callable[[torch.Tensor], torch.Tensor]
    prox_fn: Callable[[torch.Tensor, float], torch.Tensor]
    weak_convexity: float = 0.0  # rho in the paper

    def value(self, x: dict) -> torch.Tensor:
        return sum(torch.sum(self.value_fn(v)) for v in x.values())

    def prox(self, x: dict, alpha) -> dict:
        """prox_{alpha h}(x), applied leafwise over a dict of tensors."""
        return {k: self.prox_fn(v, alpha).to(v.dtype) for k, v in x.items()}

    def check_step(self, alpha) -> None:
        """Host-side guard alpha * rho < 1."""
        rho = float(self.weak_convexity)
        if rho > 0.0 and not float(alpha) * rho < 1.0:
            raise ValueError(
                f"prox of {rho}-weakly convex {self.name} needs "
                f"alpha*rho < 1, got alpha={alpha}"
            )


def _bind(name: str, lam=0.0, theta=4.0, label: str | None = None) -> ProxOperator:
    fam = get_family(name)
    fam.check_params(lam, theta)
    return ProxOperator(
        name=label if label is not None else name,
        value_fn=lambda x: fam.value_fn(x, lam, theta),
        prox_fn=lambda x, alpha: fam.prox_fn(x, alpha, lam, theta),
        weak_convexity=fam.rho_fn(theta),
    )


def make_l1(lam) -> ProxOperator:
    """h(x) = lam * ||x||_1 ; prox = soft thresholding."""
    return _bind("l1", lam, label=f"l1({lam})")


def make_l2_squared(lam) -> ProxOperator:
    """h(x) = lam/2 * ||x||^2 ; prox = shrinkage x / (1 + alpha lam)."""
    return _bind("l2sq", lam, label=f"l2sq({lam})")


def make_box_indicator(radius) -> ProxOperator:
    """h = indicator of the box [-radius, radius]^d ; prox = projection."""
    return _bind("box", radius, label=f"box({radius})")


def make_group_l2(lam) -> ProxOperator:
    """Row-group lasso: h(X) = lam * sum_rows ||X_row||_2 (block soft thr)."""
    return _bind("group_l2", lam, label=f"group_l2({lam})")


def make_mcp(lam, theta) -> ProxOperator:
    """Minimax Concave Penalty; rho = 1/theta weakly convex."""
    return _bind("mcp", lam, theta, label=f"mcp({lam},{theta})")


def make_scad(lam, theta) -> ProxOperator:
    """Smoothly Clipped Absolute Deviation (theta > 2); rho = 1/(theta-1)."""
    return _bind("scad", lam, theta, label=f"scad({lam},{theta})")


def make_zero() -> ProxOperator:
    """h = 0 (smooth problem); prox is the identity."""
    return _bind("zero", label="zero")


REGISTRY: dict[str, Callable[..., ProxOperator]] = {
    "l1": make_l1,
    "l2sq": make_l2_squared,
    "box": make_box_indicator,
    "group_l2": make_group_l2,
    "mcp": make_mcp,
    "scad": make_scad,
    "zero": lambda: make_zero(),
}


def get_prox(name: str, **kwargs) -> ProxOperator:
    if name not in REGISTRY:
        raise KeyError(f"unknown regulariser {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name](**kwargs)


# ---------------------------------------------------------------------------
# Proximal gradient mapping (paper Definition 2)
# ---------------------------------------------------------------------------

def prox_gradient(prox: ProxOperator, x: dict, grad: dict, alpha) -> dict:
    """G^alpha(x, nu) = (x - prox_{alpha h}(x - alpha nu)) / alpha  (dict)."""
    shifted = {k: x[k] - alpha * grad[k] for k in x}
    proxed = prox.prox(shifted, alpha)
    return {k: (x[k] - proxed[k]) / alpha for k in x}
