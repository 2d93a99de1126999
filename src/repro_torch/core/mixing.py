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

:func:`apply_mix` runs a plan on dicts of client-stacked tensors, and
:func:`apply_mix_sweep` on dicts of ``(S, n, ...)`` tensors: S sweep points
at once, each with its own plan point (a stacked plan) or one shared plan.
:func:`shard_body` runs a plan on one leaf's block of a client axis
sharded over a process group (the reference's body inside ``shard_map``):
the collectives of a :class:`~repro_torch.launch.mesh.ShardAxis`;
:func:`shard_mixer` runs it on every leaf of a tree, the mixer the
distributed backend, the placement mixers and the gossip mixers share.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.gossip import dense_mix_leaf, dense_mix_sweep_leaf
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

def _lead(v: torch.Tensor, x: torch.Tensor, sweep: bool) -> torch.Tensor:
    """A plan scalar shaped against leaf ``x``: 0-d (or a shared point's)
    as it is, a sweep's (S,) values as (S, 1, ..., 1)."""
    if sweep and v.ndim:
        v = v.reshape(v.shape + (1,) * (x.ndim - v.ndim))
    return v.to(x.device)


def _coef(v: torch.Tensor, x: torch.Tensor, sweep: bool) -> torch.Tensor:
    """:func:`_lead` in x's dtype."""
    return _lead(v, x, sweep).to(x.dtype)


def _chebyshev_apply(mixfn, lam, k: int, tree: dict, sweep: bool = False
                     ) -> dict:
    """P_k(W) x via the T_k recurrence: k applications of ``mixfn``.

    The lam -> 0 limit (complete graph) degenerates to a single exchange,
    matching :func:`repro_torch.core.topology.chebyshev_matrix`; the choice
    is a select on the device (per point on a sweep), never a host read.
    """
    Wx = mixfn(tree)
    if k == 1:
        return Wx  # P_1(W) = W exactly
    lam32 = lam.to(torch.float32)
    inv = 1.0 / torch.clamp_min(lam32, 1e-12)
    c = lambda s, w: _coef(s, w, sweep)
    Tm2, Tm1 = tree, {key: c(inv, w) * w for key, w in Wx.items()}
    tm2, tm1 = 1.0, inv
    for _ in range(k - 1):
        WT = mixfn(Tm1)
        Tm2, Tm1 = Tm1, {key: 2.0 * c(inv, w) * w - Tm2[key]
                         for key, w in WT.items()}
        tm2, tm1 = tm1, 2.0 * inv * tm1 - tm2
    accelerate = lam32 > 1e-9
    return {key: torch.where(_lead(accelerate, tk, sweep), tk / c(tm1, tk),
                             Wx[key])
            for key, tk in Tm1.items()}


def _mix(plan: MixPlan, tree: dict, sweep: bool) -> dict:
    """:func:`apply_mix` (``sweep`` False, client axis 0) and
    :func:`apply_mix_sweep` (client axis 1 of ``(S, n, ...)`` leaves)."""
    if plan.kind == "identity":
        return tree
    if plan.kind == "chebyshev":
        base = plan.base_plan()
        return _chebyshev_apply(lambda t: _mix(base, t, sweep), plan.lam,
                                plan.cheby_k, tree, sweep)
    axis = 1 if sweep else 0
    if plan.kind == "complete":
        return {k: torch.mean(x, dim=axis, keepdim=True).expand(x.shape)
                .contiguous() for k, x in tree.items()}
    if plan.kind == "dense":
        mix = dense_mix_sweep_leaf if sweep else dense_mix_leaf
        return {k: mix(plan.W.to(x.device), x) for k, x in tree.items()}
    # circulant: out_i = self_w * x_i + sum_k w_k * x[(i + off_k) % n]

    def leaf(x):
        out = _coef(plan.self_weight, x, sweep) * x
        for k, off in enumerate(plan.offsets):
            w = _coef(plan.weights[..., k], x, sweep)
            out = out + w * torch.roll(x, -off, dims=axis)
        return out

    return {k: leaf(x) for k, x in tree.items()}


def apply_mix(plan: MixPlan, tree: dict) -> dict:
    """x_i <- sum_j W_ij x_j on the leading client dim of every leaf.

    The circulant path rolls per offset — out_i picks up x[(i + off) % n].
    The plan's tensors should already live on the leaves' device
    (:meth:`MixPlan.to`); a mismatch costs a copy per call.
    """
    if plan.is_stacked:
        raise ValueError("apply_mix runs one plan; select a sweep point "
                         "with plan.point(s), or run a sweep with "
                         "apply_mix_sweep")
    return _mix(plan, tree, False)


def apply_mix_sweep(plan: MixPlan, tree: dict) -> dict:
    """x_si <- sum_j W_sij x_sj on ``(S, n, ...)`` leaves: every sweep point
    s mixes its own clients.

    A stacked plan gives each point its own W (dense ``(S, n, n)``: one
    batched fp32 product a leaf) or its own circulant / chebyshev weights;
    an unstacked plan is shared by every point.  The plan should already
    live on the leaves' device (:meth:`MixPlan.to`, once).
    """
    return _mix(plan, tree, True)


def as_mixer(plan: MixPlan):
    """``mix(tree) -> tree`` closure over the plan."""
    return lambda tree: apply_mix(plan, tree)


def resolve_mixer(mixer_or_plan) -> tuple[Any, Optional[MixPlan]]:
    """Normalise a Mixer-or-MixPlan argument to ``(mixer_callable, plan)``."""
    if isinstance(mixer_or_plan, MixPlan):
        return as_mixer(mixer_or_plan), mixer_or_plan
    return mixer_or_plan, None


# ---------------------------------------------------------------------------
# Per-shard execution: one block of a client axis sharded over a group
# ---------------------------------------------------------------------------

def shard_shift(x_blk: torch.Tensor, axis, off: int, n: int) -> torch.Tensor:
    """The block of position ``(i + off) % n`` of the axis, at every
    position ``i``: one ``ppermute`` (a circulant offset's exchange)."""
    return axis.ppermute(x_blk, [((s + off) % n, s) for s in range(n)])


def _gather_clients(x_blk: torch.Tensor, axis, sweep: bool) -> torch.Tensor:
    """Every shard's client block in axis order, on the client dim (dim 0,
    or dim 1 of a sweep's ``(S, blk, ...)`` block)."""
    if not sweep:
        return axis.all_gather(x_blk, tiled=True)
    return axis.all_gather(x_blk.movedim(1, 0), tiled=True).movedim(0, 1)


def _shard_dense(W: torch.Tensor, x_blk: torch.Tensor, axis,
                 sweep: bool) -> torch.Tensor:
    """Dense W on a sharded client axis: all_gather the blocks, then one
    full-fp32 product with this shard's rows of W ((n, n), or (S, n, n)
    per sweep point)."""
    gathered = _gather_clients(x_blk, axis, sweep)
    dim = 1 if sweep else 0
    blk = x_blk.shape[dim]
    i = axis.axis_index()
    rows = W[..., i * blk:(i + 1) * blk, :].to(x_blk.device, x_blk.dtype)
    if not sweep:
        return (rows @ gathered.reshape(gathered.shape[0], -1)).reshape(
            x_blk.shape)
    S, n = gathered.shape[:2]
    return torch.matmul(rows, gathered.reshape(S, n, -1)).reshape(
        x_blk.shape)


def shard_body(plan: MixPlan, x_blk: torch.Tensor, axis, n: int, *,
               sweep: bool = False) -> torch.Tensor:
    """Mix one leaf *block* of a client axis sharded over ``axis`` (a
    :class:`~repro_torch.launch.mesh.ShardAxis` of size ``n``).

    ``x_blk`` holds this shard's clients on its leading dim (on dim 1 of
    a sweep's ``(S, blk, ...)`` block, ``sweep=True``).  Kinds:

    * complete  — the block's client mean, then ``pmean`` over the axis
      (the global mean for any equal block size), broadcast back.
    * circulant — one ``ppermute`` per offset (one client per shard).
    * dense     — ``all_gather`` + a full-fp32 product with this shard's
      rows of W (TF32 must stay off on the card).
    * chebyshev — ``cheby_k`` unrolled applications of the base kind.
    * identity  — no-op.
    """
    if plan.kind == "identity":
        return x_blk
    if plan.kind == "chebyshev":
        base = plan.base_plan()
        return _chebyshev_apply(
            lambda t: {k: shard_body(base, v, axis, n, sweep=sweep)
                       for k, v in t.items()},
            plan.lam, plan.cheby_k, {"leaf": x_blk}, sweep)["leaf"]
    if plan.kind == "complete":
        local = torch.mean(x_blk, dim=1 if sweep else 0, keepdim=True)
        return axis.pmean(local).expand(x_blk.shape).contiguous()
    if plan.kind == "circulant":
        out = _coef(plan.self_weight, x_blk, sweep) * x_blk
        for k, off in enumerate(plan.offsets):
            w = _coef(plan.weights[..., k], x_blk, sweep)
            out = out + w * shard_shift(x_blk, axis, off, n)
        return out
    return _shard_dense(plan.W, x_blk, axis, sweep)


def shard_mixer(plan: MixPlan, axis, *, sweep: bool = False,
                sharded: Optional[dict] = None):
    """``mix(tree)``: :func:`shard_body` on every leaf of a client axis
    sharded over ``axis``.  ``sharded`` (leaf name -> bool; None: every
    leaf) marks the leaves whose client dim is sharded; the others hold
    every client and mix as :func:`apply_mix` does."""
    if plan.kind == "identity":
        return lambda tree: tree
    local = apply_mix_sweep if sweep else apply_mix

    def mix(tree):
        return {k: shard_body(plan, x, axis, axis.size, sweep=sweep)
                if sharded is None or sharded[k] else local(plan, {k: x})[k]
                for k, x in tree.items()}

    return mix
