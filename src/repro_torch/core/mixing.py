"""Mixing as data: the :class:`MixPlan`.

Port of ``repro/core/mixing.py`` (stacked-clients execution).  A plan
carries the mixing matrix, or the circulant weights, as tensors; its kind
and offsets are static structure.  Kinds:

* ``dense``     — W itself, ``(n, n)`` (``(S, n, n)`` when stacked).
* ``circulant`` — neighbor ``offsets`` with ``weights`` and ``self_weight``.
* ``complete``  — W = J: the client mean.
* ``identity``  — W = I: the local (no-communication) step.
* ``chebyshev`` — P_k(W) over a dense/circulant base: ``cheby_k``
  applications of the base mix via the T_k recurrence, with the base
  spectral quantity ``lam`` a 0-d tensor.

:func:`apply_mix` runs a plan on dicts of client-stacked tensors.  The
per-shard form ``shard_body`` (collectives over a process group) comes with
the backends slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.gossip import dense_mix_leaf
from repro_torch.core.topology import (
    chebyshev_matrix,
    mixing_matrix,
    spectral_lambda,
    validate_mixing,
)

_LEAVES = ("W", "weights", "self_weight", "lam")


def _f32(v, device) -> torch.Tensor:
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    return t.to(device, torch.float32)


@dataclasses.dataclass(frozen=True)
class MixPlan:
    """Mixing matrix as data.

    Build with the classmethod constructors; do not mutate.  ``kind``,
    ``offsets``, ``cheby_k`` and ``base_kind`` are static structure; the
    tensors are the data (a stacked plan carries a leading sweep axis).
    """

    kind: str
    offsets: tuple[int, ...] = ()
    W: Optional[torch.Tensor] = None            # dense: (n, n) or (S, n, n)
    weights: Optional[torch.Tensor] = None      # circulant: (k,) or (S, k)
    self_weight: Optional[torch.Tensor] = None  # circulant: () or (S,)
    lam: Optional[torch.Tensor] = None          # chebyshev: () or (S,)
    cheby_k: int = 0
    base_kind: str = ""

    # -- constructors -------------------------------------------------------
    @classmethod
    def dense(cls, W, *, device="cuda") -> "MixPlan":
        return cls(kind="dense", W=_f32(W, resolve_device(device)))

    @classmethod
    def circulant(cls, offsets_weights: Sequence[tuple[int, float]],
                  self_weight: float, *, device="cuda") -> "MixPlan":
        dev = resolve_device(device)
        offs = tuple(int(o) for o, _ in offsets_weights)
        ws = _f32([w for _, w in offsets_weights], dev)
        return cls(kind="circulant", offsets=offs, weights=ws,
                   self_weight=_f32(self_weight, dev))

    @classmethod
    def complete(cls) -> "MixPlan":
        return cls(kind="complete")

    @classmethod
    def identity(cls) -> "MixPlan":
        return cls(kind="identity")

    @classmethod
    def chebyshev(cls, base: "MixPlan", k: int,
                  n: int | None = None) -> "MixPlan":
        """Chebyshev-accelerated plan: k base-gossip exchanges per round.

        ``base`` must be an unstacked dense or circulant plan with symmetric
        W; lam = ||W - J|| is computed here on the host.  ``n`` is required
        for circulant bases.  Rejects ``k < 1`` and non-symmetric bases.
        """
        if k < 1:
            raise ValueError(f"MixPlan.chebyshev needs k >= 1, got k={k}")
        if base.kind == "chebyshev":
            raise ValueError("cannot nest chebyshev plans; raise k instead")
        if base.is_stacked:
            raise ValueError("build chebyshev plans per point, then "
                             "stack_mixplans them")
        if base.kind not in ("dense", "circulant"):
            raise ValueError(
                f"chebyshev base must be dense or circulant, got "
                f"{base.kind!r} (densify with as_dense first)")
        Wd = (base.W if base.kind == "dense" else as_dense(base, n).W)
        Wd = Wd.detach().cpu().numpy()
        if not np.allclose(Wd, Wd.T, atol=1e-6):
            raise ValueError("chebyshev base W must be symmetric "
                             "(Assumption 2)")
        lam = spectral_lambda(Wd)
        dev = (base.W if base.kind == "dense" else base.weights).device
        return cls(kind="chebyshev", offsets=base.offsets, W=base.W,
                   weights=base.weights, self_weight=base.self_weight,
                   lam=_f32(lam, dev), cheby_k=int(k), base_kind=base.kind)

    def base_plan(self) -> "MixPlan":
        """The underlying single-exchange plan of a chebyshev plan."""
        if self.kind != "chebyshev":
            return self
        return MixPlan(kind=self.base_kind, offsets=self.offsets, W=self.W,
                       weights=self.weights, self_weight=self.self_weight)

    @classmethod
    def from_topology(cls, topology: str, n: int, *, prefer: str = "dense",
                      device="cuda", **kwargs) -> "MixPlan":
        """Plan for a named topology (``repro_torch.core.topology``).

        ``prefer="dense"`` always returns a dense plan; ``prefer="sparse"``
        the cheapest exact schedule: complete (or n <= 1) -> client mean,
        ring -> circulant (n == 2 is the single shared edge), else dense.
        """
        if prefer == "sparse":
            if topology == "complete" or n <= 1:
                return cls.complete()
            if topology == "ring":
                if n == 2:
                    return cls.circulant([(+1, 0.5)], 0.5, device=device)
                return cls.circulant([(+1, 1 / 3), (-1, 1 / 3)], 1 / 3,
                                     device=device)
        W = mixing_matrix(topology, n, **kwargs)
        return cls.dense(W, device=device)

    def to(self, device) -> "MixPlan":
        """The same plan with its tensors on ``device``."""
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in _LEAVES
            if getattr(self, f) is not None})

    # -- introspection ------------------------------------------------------
    @property
    def is_stacked(self) -> bool:
        """True when the plan carries a leading sweep axis."""
        if self.kind == "dense":
            return self.W is not None and self.W.ndim == 3
        if self.kind == "circulant":
            return self.weights is not None and self.weights.ndim == 2
        if self.kind == "chebyshev":
            return self.lam is not None and self.lam.ndim == 1
        return False

    @property
    def n_sweep(self) -> int:
        if not self.is_stacked:
            return 1
        if self.kind == "chebyshev":
            return int(self.lam.shape[0])
        leaf = self.W if self.kind == "dense" else self.weights
        return int(leaf.shape[0])

    def point(self, s: int) -> "MixPlan":
        """Select one point of a stacked plan (identity on unstacked)."""
        if not self.is_stacked:
            return self
        return dataclasses.replace(self, **{
            f: getattr(self, f)[s] for f in _LEAVES
            if getattr(self, f) is not None})


def stack_mixplans(plans: Sequence[MixPlan]) -> MixPlan:
    """Stack same-structure plans on a new leading sweep axis.

    All plans must share kind (and offsets).  To sweep over *different*
    topologies, densify first: ``stack_mixplans([as_dense(p) for p in ...])``.
    """
    if not plans:
        raise ValueError("need at least one MixPlan to stack")
    kinds = {p.kind for p in plans}
    auxs = {(p.kind, p.offsets, p.cheby_k, p.base_kind) for p in plans}
    if len(auxs) > 1:
        raise ValueError(
            f"cannot stack heterogeneous plans (kinds={sorted(kinds)}, "
            f"{len(auxs)} distinct static structures); convert to dense "
            "first (as_dense) so W is the sweep leaf")
    if plans[0].kind in ("complete", "identity"):
        raise ValueError(
            f"{plans[0].kind!r} plans carry no arrays to stack; "
            "use as_dense(plan, n) to sweep over them")
    return dataclasses.replace(plans[0], **{
        f: torch.stack([getattr(p, f) for p in plans]) for f in _LEAVES
        if getattr(plans[0], f) is not None})


def as_dense(plan: MixPlan, n: int | None = None, *,
             device=None) -> MixPlan:
    """Dense equivalent of any (unstacked) plan — the universal sweep form.

    ``device`` places the W built for ``identity`` / ``complete`` plans
    (which carry no tensors); other kinds keep their own device.
    """
    if plan.is_stacked:
        raise ValueError("as_dense expects an unstacked plan")
    if plan.kind == "dense":
        return plan
    if n is None:
        raise ValueError(f"as_dense({plan.kind!r}) needs n")
    if plan.kind == "identity":
        return MixPlan.dense(torch.eye(n), device=device or "cuda")
    if plan.kind == "complete":
        return MixPlan.dense(torch.full((n, n), 1.0 / n),
                             device=device or "cuda")
    if plan.kind == "chebyshev":
        base = plan.base_plan()
        Wd = base.W if base.kind == "dense" else as_dense(base, n).W
        # host-side (chebyshev_matrix is numpy)
        Pk = chebyshev_matrix(Wd.detach().cpu().numpy(), plan.cheby_k)
        return MixPlan.dense(Pk, device=Wd.device)
    # circulant
    dev = plan.weights.device
    W = torch.zeros((n, n), device=dev)
    W = W + torch.diag(torch.full((n,), float(plan.self_weight), device=dev))
    rows = torch.arange(n, device=dev)
    for off, w in zip(plan.offsets, plan.weights):
        W[rows, (rows + off) % n] += w
    return MixPlan(kind="dense", W=W)


def plan_spectral_lambda(plan: MixPlan, n: int | None = None) -> np.ndarray:
    """Per-point lambda = ||W - J|| of a (possibly stacked) plan (host-side).

    Returns a scalar for unstacked plans, an (S,) array for stacked ones.
    """
    if plan.is_stacked:
        return np.asarray([plan_spectral_lambda(plan.point(s), n)
                           for s in range(plan.n_sweep)])
    if plan.kind == "complete":
        return np.asarray(0.0)
    if plan.kind == "identity":
        return np.asarray(1.0)
    W = as_dense(plan, n).W.detach().cpu().numpy()
    return np.asarray(spectral_lambda(W))


def validate_plan(plan: MixPlan, n: int | None = None,
                  atol: float = 1e-6, *, connected: bool = True) -> None:
    """Assumption-2 checks on a plan (host-side, per sweep point).

    Chebyshev plans are validated on their densified P_k(W) with the
    nonnegativity check relaxed; ``connected=False`` skips lambda < 1.
    """
    if plan.kind in ("complete", "identity"):
        return
    for s in range(plan.n_sweep) if plan.is_stacked else (None,):
        p = plan if s is None else plan.point(s)
        validate_mixing(as_dense(p, n).W.detach().cpu().numpy(), atol=atol,
                        allow_negative=(p.kind == "chebyshev"),
                        connected=connected)


# ---------------------------------------------------------------------------
# Stacked-clients execution
# ---------------------------------------------------------------------------

def _chebyshev_apply(mixfn, lam, k: int, tree: dict) -> dict:
    """P_k(W) x via the T_k recurrence: k applications of ``mixfn``.

    The lam -> 0 limit (complete graph) degenerates to a single exchange,
    matching :func:`repro_torch.core.topology.chebyshev_matrix`.
    """
    Wx = mixfn(tree)
    if k == 1:
        return Wx  # P_1(W) = W exactly
    lam32 = lam.to(torch.float32)
    inv = 1.0 / torch.clamp_min(lam32, 1e-12)
    Tm2, Tm1 = tree, {key: inv.to(w.dtype) * w for key, w in Wx.items()}
    tm2, tm1 = 1.0, inv
    for _ in range(k - 1):
        WT = mixfn(Tm1)
        Tm2, Tm1 = Tm1, {key: 2.0 * inv.to(w.dtype) * w - Tm2[key]
                         for key, w in WT.items()}
        tm2, tm1 = tm1, 2.0 * inv * tm1 - tm2
    if not float(lam32) > 1e-9:
        return Wx
    return {key: tk / tm1.to(tk.dtype) for key, tk in Tm1.items()}


def apply_mix(plan: MixPlan, tree: dict) -> dict:
    """x_i <- sum_j W_ij x_j on the leading client dim of every leaf.

    The circulant path rolls per offset — out_i picks up x[(i + off) % n].
    The plan's tensors should already live on the leaves' device
    (:meth:`MixPlan.to`); a mismatch costs a copy per call.
    """
    if plan.is_stacked:
        raise ValueError("apply_mix runs one plan; select a sweep point "
                         "with plan.point(s)")
    if plan.kind == "identity":
        return tree
    if plan.kind == "chebyshev":
        base = plan.base_plan()
        return _chebyshev_apply(lambda t: apply_mix(base, t), plan.lam,
                                plan.cheby_k, tree)
    if plan.kind == "complete":
        return {k: torch.mean(x, dim=0, keepdim=True).expand(x.shape)
                .contiguous() for k, x in tree.items()}
    if plan.kind == "dense":
        return {k: dense_mix_leaf(plan.W.to(x.device), x)
                for k, x in tree.items()}
    # circulant: out_i = self_w * x_i + sum_k w_k * x[(i + off_k) % n]

    def leaf(x):
        ws = plan.weights.to(x.device, x.dtype)
        out = plan.self_weight.to(x.device, x.dtype) * x
        for k, off in enumerate(plan.offsets):
            out = out + ws[k] * torch.roll(x, -off, dims=0)
        return out

    return {k: leaf(x) for k, x in tree.items()}


def as_mixer(plan: MixPlan):
    """``mix(tree) -> tree`` closure over the plan."""
    return lambda tree: apply_mix(plan, tree)


def resolve_mixer(mixer_or_plan) -> tuple[Any, Optional[MixPlan]]:
    """Normalise a Mixer-or-MixPlan argument to ``(mixer_callable, plan)``."""
    if isinstance(mixer_or_plan, MixPlan):
        return as_mixer(mixer_or_plan), mixer_or_plan
    return mixer_or_plan, None
