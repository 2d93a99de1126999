"""Round-indexed communication: the :class:`MixSchedule` operand.

Port of ``repro/core/schedule.py`` (stacked-clients execution).  A
schedule says how round ``r`` communicates:

* ``constant``    — one plan for every round (the static-plan path, op for
  op);
* ``stacked``     — plan leaves carry a leading round axis ``(R, ...)``;
  round ``r`` uses ``plan[r]`` (clamped at R - 1 past the end);
* ``lazy(p)``     — Remark 3 partial participation: a per-round 0/1
  ``active`` mask, pre-drawn with numpy (``rounds=R``, the reference's
  draws exactly) or redrawn each round by a
  :class:`~repro_torch.core.cohort.CohortSampler` (``rounds=None``); round
  ``r`` applies the lazy-subgraph matrix of the base plan (inactive mass
  folds into the diagonal).  Inactive clients skip communication only;
* ``cohort``      — the padded client axis: a sampler draws each round's
  cohort, whose mask gates both the mix (lazy-subgraph semantics over the
  padded dense plan) and the round program's local updates (inactive and
  padding rows freeze, ``repro_torch.core.depositum``);
* ``chebyshev(k)``— a constant schedule over a ``MixPlan.chebyshev`` plan;
* ``alternating`` — ``plan[r % P]`` over a period-P stack.

Schedules stack on a leading *sweep* axis (:func:`stack_schedules`;
heterogeneous grids densify to the per-round ``stacked`` form first,
:func:`as_stacked_schedule`).  :func:`apply_schedule` runs one schedule on
``(n, ...)`` leaves, :func:`apply_schedule_sweep` a stacked (or shared)
schedule on ``(S, n, ...)`` leaves.  The round index ``r`` is a host
integer, ``t // T0``.

A schedule may carry a :class:`~repro_torch.core.compression.
CompressionSpec` (:meth:`MixSchedule.with_compression`): its comm steps
then run the CHOCO error-feedback exchange of
:mod:`repro_torch.core.compression` (``repro_torch.core.depositum``).

On a client axis sharded over a process group, :func:`shard_schedule_body`
runs round ``r``'s mix of one leaf block through the collectives of a
:class:`~repro_torch.launch.mesh.ShardAxis`, and
:func:`shard_compressed_qmix` mixes a compressed increment with its packed
payload on the wire (:func:`wire_supported` says when it can);
:func:`shard_schedule_mixer` builds the round-indexed mixer of both, the
one the distributed backend and the placement mixers share.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.cohort import CohortSampler
from repro_torch.core.compression import (
    CompressionSpec,
    as_mixed,
    check_spec,
    pack_payload,
    stack_specs,
    unpack_payload,
    wire_mode,
)
from repro_torch.core.mixing import (
    _LEAVES as _PLAN_LEAVES,
    MixPlan,
    _coef,
    apply_mix,
    apply_mix_sweep,
    as_dense,
    shard_body,
    shard_shift,
    stack_mixplans,
    validate_plan,
)
from repro_torch.core.gossip import dense_mix_leaf, dense_mix_sweep_leaf
from repro_torch.core.topology import (
    lazy_subgraph_matrix,
    spectral_lambda,
    validate_mixing,
)

#: ``validate_schedule(rounds=None)`` checks at most this many rounds per
#: sweep point (one dense host matrix a round does not scale to long or
#: sampler-driven horizons).
VALIDATE_ROUNDS_CAP = 16


def _plan_lead_leaf(plan: MixPlan) -> torch.Tensor:
    """The leaf whose leading axes carry a plan's sweep / round stacking."""
    if plan.kind == "chebyshev":
        return plan.lam
    return plan.W if plan.kind == "dense" else plan.weights


def _plan_extra_ndim(plan: MixPlan) -> int:
    """Leaf dims beyond the base rank (0 = plain, 1 = one extra axis...)."""
    if plan.kind == "chebyshev":
        return plan.lam.ndim
    if plan.kind == "dense":
        return plan.W.ndim - 2
    if plan.kind == "circulant":
        return plan.weights.ndim - 1
    return 0


def _plan_index(plan: MixPlan, idx, axis: int) -> MixPlan:
    """``plan`` with every leaf indexed at ``idx`` on ``axis`` (a view)."""
    return dataclasses.replace(plan, **{
        f: getattr(plan, f).select(axis, idx) for f in _PLAN_LEAVES
        if getattr(plan, f) is not None})


def _host_W(plan: MixPlan, n: int | None) -> np.ndarray:
    """A plan's dense W as a host array."""
    return as_dense(plan, n, device="cpu").W.detach().cpu().numpy()


def _plan_device(plan: MixPlan) -> torch.device:
    for f in _PLAN_LEAVES:
        if getattr(plan, f) is not None:
            return getattr(plan, f).device
    return torch.device("cpu")


@dataclasses.dataclass(frozen=True)
class MixSchedule:
    """Round-indexed communication pattern.

    Build with the classmethod constructors.  ``kind`` and ``period`` are
    structure; ``plan``, ``active``, ``sampler`` and ``compress`` carry the
    tensors.
    """

    kind: str
    plan: MixPlan                            # base / round-stacked plan
    active: Optional[torch.Tensor] = None    # lazy: (R, n) or (S, R, n)
    period: int = 0                          # alternating only
    sampler: Optional[CohortSampler] = None  # cohort / redrawn lazy
    compress: Optional[CompressionSpec] = None  # what comm steps transmit

    # -- constructors -------------------------------------------------------
    @classmethod
    def constant(cls, plan: MixPlan) -> "MixSchedule":
        """One plan for every round."""
        if plan.is_stacked:
            raise ValueError(
                "constant schedules take an unstacked plan; use "
                "MixSchedule.stacked for a per-round stack, or "
                "stack_schedules for a sweep axis")
        return cls(kind="constant", plan=plan)

    @classmethod
    def stacked(cls, plans) -> "MixSchedule":
        """Per-round plans: a list of same-kind plans or an already-stacked
        plan whose leading leaf axis is the round axis."""
        plan = plans if isinstance(plans, MixPlan) else stack_mixplans(
            list(plans))
        if _plan_extra_ndim(plan) != 1:
            raise ValueError("stacked schedules need plan leaves with one "
                             "leading (rounds) axis")
        return cls(kind="stacked", plan=plan)

    @classmethod
    def alternating(cls, plans: Sequence[MixPlan]) -> "MixSchedule":
        """Cycle through ``plans``: round r communicates with plan[r % P]."""
        plans = list(plans)
        if len(plans) < 2:
            raise ValueError("alternating schedules need >= 2 plans "
                             "(use constant for one)")
        return cls(kind="alternating", plan=stack_mixplans(plans),
                   period=len(plans))

    @classmethod
    def lazy(cls, plan: MixPlan, p_active: float, rounds: int | None = None,
             *, n: int | None = None, seed: int = 0,
             rng: np.random.Generator | None = None) -> "MixSchedule":
        """Remark 3 partial participation over ``plan``'s graph.

        Each round an i.i.d. Bernoulli(``p_active``) subset of clients is
        active; only edges with both endpoints active communicate, the rest
        of the mass folds into the diagonal.  ``n`` is required for
        circulant bases.  With ``rounds`` the ``(R, n)`` mask is drawn here
        on the host from ``rng`` / ``seed`` (numpy, the reference's draws
        exactly); with ``rounds=None`` a :class:`CohortSampler` seeded by
        ``seed`` redraws each round's mask on the plan's device.
        """
        if not 0.0 <= p_active <= 1.0:
            raise ValueError(f"p_active must be in [0, 1], got {p_active}")
        if rounds is not None and rounds < 1:
            raise ValueError(f"lazy schedules need rounds >= 1 (or None "
                             f"for the on-device draw), got {rounds}")
        if plan.is_stacked:
            raise ValueError("lazy schedules take an unstacked base plan")
        if plan.kind not in ("dense", "circulant"):
            if n is None:
                raise ValueError(f"lazy over a {plan.kind!r} plan needs n "
                                 "to densify")
            plan = as_dense(plan, n, device=_plan_device(plan))
        if plan.kind == "dense":
            n = int(plan.W.shape[-1])
        elif n is None:
            raise ValueError("lazy over a circulant plan needs n")
        dev = _plan_device(plan)
        if rounds is None:
            if rng is not None:
                raise ValueError("rounds=None draws masks on device; a "
                                 "host rng does not apply (use seed=)")
            sampler = CohortSampler.bernoulli(p_active, n, seed=seed,
                                              device=dev)
            return cls(kind="lazy", plan=plan, sampler=sampler)
        rng = rng if rng is not None else np.random.default_rng(seed)
        mask = rng.random((rounds, n)) < p_active
        return cls(kind="lazy", plan=plan,
                   active=torch.as_tensor(mask, dtype=torch.float32,
                                          device=dev))

    @classmethod
    def cohort(cls, plan: MixPlan, sampler: CohortSampler) -> "MixSchedule":
        """Padded client axis + per-round cohort participation.

        ``plan`` must be a dense ``(n_max, n_max)`` plan (pad a smaller
        graph with :func:`~repro_torch.core.cohort.pad_plan`).  Unlike
        ``lazy``, the drawn mask gates the whole round: inactive and
        padding rows neither communicate nor take local steps.
        """
        if not isinstance(sampler, CohortSampler):
            raise TypeError("cohort schedules need a CohortSampler, got "
                            f"{type(sampler).__name__}")
        if plan.is_stacked:
            raise ValueError("cohort schedules take an unstacked plan; "
                             "stack whole schedules for a sweep axis")
        if plan.kind != "dense":
            raise ValueError(
                f"cohort schedules need a dense (padded) plan, got "
                f"{plan.kind!r}; densify/pad first (pad_plan)")
        if int(plan.W.shape[-1]) != sampler.n_max:
            raise ValueError(
                f"plan is {plan.W.shape[-1]}x{plan.W.shape[-1]} but the "
                f"sampler pads to n_max={sampler.n_max}")
        return cls(kind="cohort", plan=plan, sampler=sampler)

    @classmethod
    def chebyshev(cls, base: MixPlan, k: int,
                  n: int | None = None) -> "MixSchedule":
        """Every round = k Chebyshev-accelerated exchanges over ``base``."""
        if base.kind == "chebyshev":
            if base.cheby_k != k:
                raise ValueError(
                    f"base plan already runs k={base.cheby_k} chebyshev "
                    f"exchanges; refusing to silently ignore k={k} "
                    "(pass the raw base plan instead)")
            plan = base
        else:
            plan = MixPlan.chebyshev(base, k, n=n)
        return cls(kind="chebyshev", plan=plan)

    @classmethod
    def from_topology(cls, topology: str, n: int, **kwargs) -> "MixSchedule":
        """Constant schedule for a named topology."""
        return cls.constant(MixPlan.from_topology(topology, n, **kwargs))

    def with_compression(self, spec: Optional[CompressionSpec]
                         ) -> "MixSchedule":
        """This schedule transmitting ``spec``-compressed increments.

        ``spec=None`` and a ``kind="none"`` spec leave the round program on
        the dense path, bit for bit.  Any other kind makes each comm step a
        CHOCO error-feedback exchange: the state must carry the memory
        (``repro_torch.core.depositum.init(compress=...)``).  A stacked
        spec needs a stacked schedule (:func:`stack_schedules` stacks both).
        """
        if spec is not None and not isinstance(spec, CompressionSpec):
            raise TypeError("with_compression takes a CompressionSpec, got "
                            f"{type(spec).__name__}")
        if spec is not None and spec.is_stacked and (
                not self.is_stacked or spec.n_sweep != self.n_sweep):
            raise ValueError(
                f"a spec stacked over {spec.n_sweep} points needs a schedule "
                "stacked over as many; stack whole schedules instead "
                "(stack_schedules)")
        return dataclasses.replace(self, compress=spec)

    # -- introspection ------------------------------------------------------
    @property
    def is_stacked(self) -> bool:
        """True when the schedule carries a leading *sweep* axis (the round
        axis of stacked / alternating / lazy kinds is one level in)."""
        if self.kind == "cohort":
            return self.sampler.is_stacked
        if self.kind == "lazy":
            if self.active is None:
                return self.sampler.is_stacked
            return self.active.ndim == 3
        extra = _plan_extra_ndim(self.plan)
        return extra == (2 if self.kind in ("stacked", "alternating")
                         else 1)

    @property
    def n_sweep(self) -> int:
        if not self.is_stacked:
            return 1
        if self.kind == "cohort" or (self.kind == "lazy" and
                                     self.active is None):
            return self.sampler.n_sweep
        if self.kind == "lazy":
            return int(self.active.shape[0])
        return int(_plan_lead_leaf(self.plan).shape[0])

    @property
    def n_rounds(self) -> Optional[int]:
        """Length of the round axis (None for round-invariant and
        sampler-driven kinds).  Rounds past the end clamp to the last entry
        (``alternating`` wraps with its period)."""
        if self.kind in ("constant", "chebyshev", "alternating", "cohort"):
            return None
        if self.kind == "lazy":
            return None if self.active is None else int(
                self.active.shape[-2])
        leaf = _plan_lead_leaf(self.plan)
        return int(leaf.shape[1] if self.is_stacked else leaf.shape[0])

    def point(self, s: int) -> "MixSchedule":
        """Select one sweep point (identity on unswept schedules)."""
        if not self.is_stacked:
            return self
        swept_plan = self.kind not in ("lazy", "cohort") or \
            _plan_extra_ndim(self.plan) > 0
        return dataclasses.replace(
            self, plan=_plan_index(self.plan, s, 0) if swept_plan
            else self.plan,
            active=None if self.active is None else self.active[s],
            sampler=None if self.sampler is None else self.sampler.point(s),
            compress=None if self.compress is None
            else self.compress.point(s))

    def to(self, device) -> "MixSchedule":
        """The same schedule with its tensors on ``device``."""
        return dataclasses.replace(
            self, plan=self.plan.to(device),
            active=None if self.active is None else self.active.to(device),
            sampler=None if self.sampler is None else self.sampler.to(device),
            compress=None if self.compress is None
            else self.compress.to(device))

    def _round_index(self, r: int) -> int:
        if self.kind == "alternating":
            return int(r) % self.period
        return min(int(r), self.n_rounds - 1)

    def plan_at(self, r: int) -> MixPlan:
        """The concrete effective plan of round ``r`` (unswept schedules
        only): the reference the mixing paths are tested against, and the
        validation / lambda-reporting form."""
        if self.is_stacked:
            raise ValueError("select a sweep point first (schedule.point)")
        if self.kind in ("constant", "chebyshev"):
            return self.plan
        if self.kind in ("alternating", "stacked"):
            return self.plan.point(self._round_index(r))
        # lazy / cohort: fold this round's inactive mass into the diagonal
        a = _active_mask(self, r, False).detach().cpu().numpy()
        base = self.plan if self.plan.kind == "dense" else as_dense(
            self.plan, a.shape[-1])
        Wt = lazy_subgraph_matrix(base.W.detach().cpu().numpy(), a > 0.5)
        return MixPlan.dense(Wt, device=_plan_device(self.plan))


# ---------------------------------------------------------------------------
# Stacked-clients execution
# ---------------------------------------------------------------------------

def _lazy_dense_matrix(W: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The lazy-subgraph matrix on the device: W masked by the active-edge
    outer product, inactive mass folded into the diagonal (Remark 3).  ``W``
    is (n, n) or (S, n, n), ``a`` (n,) or (S, n).

    The diagonal is ``W_ii + (dropped off-diagonal mass)``, so an
    all-active mask gives W back bit for bit.
    """
    mask = (a[..., :, None] * a[..., None, :]).to(W.dtype)
    diag = torch.diagonal(W, dim1=-2, dim2=-1)
    offdiag = W - torch.diag_embed(diag)
    kept = offdiag * mask
    dropped = offdiag * (1.0 - mask)
    return kept + torch.diag_embed(diag + torch.sum(dropped, dim=-1))


def _apply_lazy(plan: MixPlan, a: torch.Tensor, tree: dict,
                sweep: bool) -> dict:
    """One lazy round: a dense masked product, or per-offset masked rolls
    for circulant bases."""
    if plan.kind == "dense":
        Wt = _lazy_dense_matrix(plan.W, a.to(plan.W.device))
        mix = dense_mix_sweep_leaf if sweep else dense_mix_leaf
        return {k: mix(Wt.to(x.device), x) for k, x in tree.items()}
    # circulant: out_i = x_i + sum_k w_k a_i a_{i+off_k} (x_{i+off_k} - x_i)
    axis = 1 if sweep else 0

    def leaf(x):
        out = x
        for k, off in enumerate(plan.offsets):
            m = a * torch.roll(a, -off, dims=-1)
            if sweep and m.ndim == 1:
                m = m[None]
            m = m.reshape(m.shape + (1,) * (x.ndim - m.ndim)).to(
                x.device, x.dtype)
            w = _coef(plan.weights[..., k], x, sweep)
            out = out + w * m * (torch.roll(x, -off, dims=axis) - x)
        return out

    return {k: leaf(x) for k, x in tree.items()}


def _active_mask(sched: MixSchedule, r: int, sweep: bool) -> torch.Tensor:
    """Round ``r``'s 0/1 active mask of a lazy / cohort schedule: (n,), or
    (S, n) for a stacked schedule on the sweep path."""
    if sched.active is not None:
        axis = 1 if sweep and sched.is_stacked else 0
        return sched.active.select(axis, sched._round_index(r))
    return sched.sampler.mask_at(r)


def _schedule_mix(sched: MixSchedule, r: int, tree: dict,
                  sweep: bool) -> dict:
    if sched.kind in ("constant", "chebyshev"):
        return (apply_mix_sweep if sweep else apply_mix)(sched.plan, tree)
    if sched.kind in ("stacked", "alternating"):
        axis = 1 if sweep and sched.is_stacked else 0
        plan = _plan_index(sched.plan, sched._round_index(r), axis)
        return (apply_mix_sweep if sweep else apply_mix)(plan, tree)
    return _apply_lazy(sched.plan, _active_mask(sched, r, sweep), tree,
                       sweep)


def apply_schedule(sched: MixSchedule, r: int, tree: dict) -> dict:
    """Round ``r``'s mix on the leading client dim of every leaf.

    A ``constant`` schedule runs exactly ``apply_mix(plan, tree)``.
    """
    if sched.is_stacked:
        raise ValueError("apply_schedule runs one schedule; select a sweep "
                         "point with schedule.point(s), or run a sweep "
                         "with apply_schedule_sweep")
    return _schedule_mix(sched, r, tree, False)


def apply_schedule_sweep(sched: MixSchedule, r: int, tree: dict) -> dict:
    """Round ``r``'s mix on ``(S, n, ...)`` leaves: a stacked schedule
    gives every sweep point its own plan, mask or sampler draw; an unswept
    one is shared by every point."""
    return _schedule_mix(sched, r, tree, True)


def schedule_round_mask(mixer_or_sched, r: int) -> Optional[torch.Tensor]:
    """The mask gating round ``r``'s *state updates*, or None.

    Only ``cohort`` schedules gate local compute (inactive and padding rows
    freeze for the whole round): (n,), or (S, n) for a stacked schedule.
    The round program calls this once a round.  Accepts a
    :class:`MixSchedule` or a :class:`ScheduleMixer`; a mixer built for
    one shard of the client axis (``rows``) gives that shard's rows of the
    global mask.
    """
    sched = getattr(mixer_or_sched, "schedule", mixer_or_sched)
    if isinstance(sched, MixSchedule) and sched.kind == "cohort":
        mask = sched.sampler.mask_at(r)
        rows = getattr(mixer_or_sched, "rows", None)
        return mask if rows is None else mask[..., rows]
    return None


def as_schedule(mixer_or_plan) -> MixSchedule:
    """Normalise a plan to a constant schedule (identity on schedules)."""
    if isinstance(mixer_or_plan, MixSchedule):
        return mixer_or_plan
    if isinstance(mixer_or_plan, MixPlan):
        return MixSchedule.constant(mixer_or_plan)
    raise TypeError(f"cannot build a MixSchedule from "
                    f"{type(mixer_or_plan).__name__}")


@dataclasses.dataclass(frozen=True)
class ScheduleMixer:
    """A round-indexed mixer ``mix(tree, r) -> tree``, built by the
    execution backends; the round program supplies ``r = t // T0``.

    ``wire_fn`` — when a sharded backend can ship the schedule's
    compressed increments packed (:func:`wire_supported`) — mixes ``q``
    with value / index pairs or int8 words on the collectives, so the
    CHOCO exchange puts fewer bytes on the wire than ``fn`` would; None
    means ``q`` rides ``fn``.  ``rows`` is the slice of the global client
    axis this process holds (None: all of it); the round program takes
    those rows of the schedule's global masks (:func:`schedule_round_mask`).
    """

    fn: Callable[[dict, int], dict]
    schedule: MixSchedule
    wire_fn: Optional[Callable[[dict, int], dict]] = None
    rows: Optional[slice] = None

    def __call__(self, tree: dict, r: int) -> dict:
        return self.fn(tree, r)


# ---------------------------------------------------------------------------
# Per-shard execution: one block of a client axis sharded over a group
# ---------------------------------------------------------------------------

def shard_round_plan(sched: MixSchedule, r: int,
                     sweep: bool = False) -> Optional[MixPlan]:
    """Round ``r``'s mix as one plan for :func:`~repro_torch.core.mixing.
    shard_body`, resolved once for a whole tree: the schedule's plan, the
    round's point of a stacked / alternating one, or the lazy-subgraph
    dense matrix of a lazy / cohort round over a dense base.  None for a
    lazy round over a circulant base, whose ppermutes are masked edge by
    edge."""
    if sched.kind in ("constant", "chebyshev"):
        return sched.plan
    if sched.kind in ("stacked", "alternating"):
        at = 1 if sweep and sched.is_stacked else 0
        return _plan_index(sched.plan, sched._round_index(r), at)
    if sched.plan.kind != "dense":
        return None
    W = sched.plan.W
    return MixPlan(kind="dense", W=_lazy_dense_matrix(
        W, _active_mask(sched, r, sweep).to(W.device)))


def shard_schedule_body(sched: MixSchedule, r: int, x_blk: torch.Tensor,
                        axis, n: int, *, sweep: bool = False,
                        plan: Optional[MixPlan] = None) -> torch.Tensor:
    """Round ``r``'s mix of one leaf block on a client axis sharded over
    ``axis`` (size ``n``); ``sweep`` as in :func:`~repro_torch.core.
    mixing.shard_body`.

    Dispatch follows :func:`~repro_torch.core.mixing.shard_body` per plan
    kind; the schedule adds:

    * ``stacked`` / ``alternating`` — the round's plan is indexed out of
      the (replicated) stacked operand, then mixed as usual.
    * ``lazy`` / ``cohort`` over a dense base — the lazy-subgraph matrix of
      the round's global mask (drawn identically on every process from the
      replicated generator: no extra collective) masks the all_gather
      contraction's rows.  A cohort's padding rows are identity rows.
    * ``lazy`` over a circulant base — each ``ppermute`` contribution is
      masked by its active-edge value ``a_i * a_{(i+off) % n}`` (one
      client per process, like every circulant shard plan).
    * ``chebyshev`` — k unrolled collectives through the plan's dispatch.

    ``plan``: round ``r``'s :func:`shard_round_plan`, when the caller has
    resolved it once for a whole tree.
    """
    if plan is None:
        plan = shard_round_plan(sched, r, sweep)
    if plan is not None:
        return shard_body(plan, x_blk, axis, n, sweep=sweep)
    a = _active_mask(sched, r, sweep)
    plan = sched.plan
    i = axis.axis_index()
    out = x_blk
    for k, off in enumerate(plan.offsets):
        nb = shard_shift(x_blk, axis, off, n)
        m = a[..., i] * a[..., (i + off) % n]
        w = _coef(plan.weights[..., k], x_blk, sweep)
        out = out + w * _coef(m, x_blk, sweep) * (nb - x_blk)
    return out


def wire_supported(sched: MixSchedule) -> bool:
    """True when this schedule's compressed increments can cross the
    collectives *packed* (:func:`shard_compressed_qmix`).

    Needs a spec with a wire form (``wire_k > 0`` sparse, or qsgd) and a
    round mix that is a single exchange: the dense-base family (constant /
    stacked / alternating / lazy / cohort over dense plans — packed
    ``all_gather`` + row contraction) or a constant circulant (packed
    ``ppermute`` per offset).  Chebyshev rounds re-mix their own output k
    times and complete / identity plans carry no per-edge payload: those
    mix ``q`` with the dense collective (compression still shapes the
    values, and :mod:`repro_torch.analysis.comm` still prices them).
    """
    if wire_mode(sched.compress) is None:
        return False
    if sched.plan.kind == "dense" and sched.kind in (
            "constant", "stacked", "alternating", "lazy", "cohort"):
        return True
    return sched.plan.kind == "circulant" and sched.kind == "constant"


def shard_compressed_qmix(sched: MixSchedule, r: int, q_blk: torch.Tensor,
                          axis, n: int, *,
                          plan: Optional[MixPlan] = None) -> torch.Tensor:
    """Round ``r``'s mix of a compressed increment block with its packed
    payload on the wire (one configuration, ``(blk, ...)`` rows).

    Where :func:`~repro_torch.core.mixing.shard_body` would put the dense
    block on the collective, this packs it first
    (:func:`~repro_torch.core.compression.pack_payload`: ``wire_k``
    value / index pairs a row, or int8 words and a row norm), one
    collective a payload component.  The result equals the dense mix of
    ``q`` whenever the payload fits (``nnz <= wire_k``; qsgd levels <=
    127).  Only under :func:`wire_supported`; the round matrix is
    :func:`shard_round_plan`'s (``plan``, when resolved once a tree).
    """
    spec = sched.compress
    blk = q_blk.shape[0]
    flat = q_blk.reshape(blk, -1)
    d = flat.shape[-1]
    payload = pack_payload(spec, flat)
    base = sched.plan
    if base.kind == "circulant":
        out = _coef(base.self_weight, q_blk, False) * q_blk
        for k, off in enumerate(base.offsets):
            nb = unpack_payload(spec, tuple(shard_shift(p, axis, off, n)
                                            for p in payload), d, q_blk.dtype)
            out = out + _coef(base.weights[k], q_blk, False) * nb.reshape(
                q_blk.shape)
        return out
    gathered = tuple(axis.all_gather(p, tiled=True) for p in payload)
    q_full = unpack_payload(spec, gathered, d, q_blk.dtype)
    W = (shard_round_plan(sched, r) if plan is None else plan).W
    i = axis.axis_index()
    rows = W[i * blk:(i + 1) * blk].to(q_blk.device, q_blk.dtype)
    return (rows @ q_full).reshape(q_blk.shape)


def shard_schedule_mixer(sched: MixSchedule, axis, rows: Optional[slice],
                         *, sweep: bool = False,
                         sharded: Optional[dict] = None) -> ScheduleMixer:
    """The round-indexed mixer of ``sched`` on a client axis sharded over
    ``axis``: :func:`shard_schedule_body` on every leaf, the round's plan
    resolved once a tree, and, where the compressed increments pack
    (:func:`wire_supported`, one configuration, every leaf sharded),
    ``wire_fn`` (:func:`shard_compressed_qmix`).  ``sharded`` (leaf name
    -> bool; None: every leaf) marks the leaves whose client dim is
    sharded; the others hold every client and mix as the stacked schedule
    does.  ``rows``: this process's block of the global client axis."""
    n = axis.size
    local = apply_schedule_sweep if sweep else apply_schedule
    every = sharded is None or all(sharded.values())

    def mix(tree, r):
        plan = shard_round_plan(sched, r, sweep)        # once a tree
        return {k: shard_schedule_body(sched, r, x, axis, n, sweep=sweep,
                                       plan=plan)
                if sharded is None or sharded[k]
                else local(sched, r, {k: x})[k] for k, x in tree.items()}

    wire = None
    if every and not sweep and not sched.is_stacked and wire_supported(sched):
        def wire(tree, r):
            plan = shard_round_plan(sched, r)
            return {k: shard_compressed_qmix(sched, r, x, axis, n, plan=plan)
                    for k, x in tree.items()}

    return ScheduleMixer(mix, sched, wire_fn=wire, rows=rows)


# ---------------------------------------------------------------------------
# Sweep plumbing: schedules as a sweep dimension
# ---------------------------------------------------------------------------

def stack_schedules(schedules: Sequence[MixSchedule]) -> MixSchedule:
    """Stack same-structure schedules on a new leading sweep axis.

    All schedules must agree on kind, period and the plan's structure (a
    ``p_active`` grid of lazy schedules over one graph stacks directly).
    Grids that mix kinds, or chebyshev orders, densify to the per-round
    ``stacked`` form first:
    ``stack_schedules([as_stacked_schedule(s, rounds, n) ...])``.

    Compression specs normalise to one structure: a missing spec becomes
    ``none``, and specs that differ in ``(kind, wire_k, wire_bits)`` (or
    are mixed already) become the ``mixed`` form, so a grid of top-k rates,
    QSGD bits and a dense baseline stacks as one operand.
    """
    schedules = list(schedules)
    if not schedules:
        raise ValueError("need at least one MixSchedule to stack")
    specs = [s.compress for s in schedules]
    if any(sp is not None for sp in specs):
        dev = next(sp.ef_step.device for sp in specs if sp is not None)
        specs = [CompressionSpec.none(device=dev) if sp is None else sp
                 for sp in specs]
        if len({(sp.kind, sp.wire_k, sp.wire_bits) for sp in specs}) > 1 \
                or specs[0].kind == "mixed":
            specs = [as_mixed(sp) for sp in specs]
        schedules = [dataclasses.replace(s, compress=sp)
                     for s, sp in zip(schedules, specs)]
    auxs = {(s.kind, s.period, s.plan.kind, s.plan.offsets, s.plan.cheby_k,
             s.plan.base_kind, s.active is None,
             None if s.sampler is None else (s.sampler.kind,
                                             s.sampler.n_max),
             None if s.compress is None else (s.compress.kind,
                                              s.compress.wire_k,
                                              s.compress.wire_bits))
            for s in schedules}
    if len(auxs) > 1:
        raise ValueError(
            f"cannot stack heterogeneous schedules ({len(auxs)} distinct "
            "static structures); densify to a common per-round form first "
            "(as_stacked_schedule)")
    if any(s.is_stacked for s in schedules):
        raise ValueError("schedules are already sweep-stacked")
    s0 = schedules[0]
    if s0.plan.kind in ("complete", "identity"):
        raise ValueError(
            f"{s0.plan.kind!r} plans carry no arrays to stack; "
            "densify first (as_stacked_schedule / as_dense)")
    from repro_torch.core.cohort import stack_cohorts
    return dataclasses.replace(
        s0, plan=stack_mixplans([s.plan for s in schedules]),
        active=None if s0.active is None else torch.stack(
            [s.active for s in schedules]),
        sampler=None if s0.sampler is None else stack_cohorts(
            [s.sampler for s in schedules]),
        compress=None if s0.compress is None else stack_specs(
            [s.compress for s in schedules]))


def as_stacked_schedule(sched: MixSchedule, rounds: int,
                        n: int | None = None) -> MixSchedule:
    """Densified universal sweep form: per-round dense W of shape (R, n, n),
    built on the host.  Any kind but ``cohort`` reduces to it, so
    heterogeneous schedule grids stack into one sweep."""
    if sched.is_stacked:
        raise ValueError("as_stacked_schedule expects an unswept schedule")
    if sched.kind == "cohort":
        raise ValueError(
            "cohort schedules do not densify: the drawn mask also gates "
            "local state updates, which a per-round W stack cannot "
            "express — sweep cohort schedules directly (stack_schedules)")
    Ws = np.stack([_host_W(sched.plan_at(r), n) for r in range(rounds)])
    return MixSchedule(kind="stacked", plan=MixPlan.dense(
        Ws, device=_plan_device(sched.plan)))


def validate_schedule(sched: MixSchedule, n: int | None = None,
                      atol: float = 1e-6, rounds: int | None = None) -> None:
    """Assumption-2 checks per sweep point, per distinct round (host-side).

    Round-varying kinds may be non-contracting in a single round (Remark 3
    needs contraction in expectation only); a round-invariant plan must
    contract.  Stacked / alternating rounds may carry negative entries
    (densified chebyshev matrices).  Lazy and cohort schedules also check
    their base plan.  With ``rounds=None`` round-varying kinds are sampled
    at no more than :data:`VALIDATE_ROUNDS_CAP` rounds a point.  A
    compression spec is range-checked (rates in (0, 1], bits >= 1).
    """
    if sched.compress is not None:
        check_spec(sched.compress)
    for s in range(sched.n_sweep) if sched.is_stacked else (None,):
        ss = sched if s is None else sched.point(s)
        if ss.kind in ("lazy", "cohort"):
            validate_plan(ss.plan, n, atol=atol, connected=False)
        if ss.kind in ("constant", "chebyshev"):
            R = 1
        elif ss.kind == "alternating":
            R = ss.period
        else:
            horizon = ss.n_rounds
            if rounds is not None:
                R = rounds if horizon is None else min(rounds, horizon)
            elif horizon is None:
                R = VALIDATE_ROUNDS_CAP
            else:
                R = min(horizon, VALIDATE_ROUNDS_CAP)
        for r in range(R):
            plan_r = ss.plan_at(r)
            if ss.kind in ("stacked", "alternating"):
                validate_mixing(_host_W(plan_r, n), atol=atol,
                                allow_negative=True, connected=False)
            else:
                validate_plan(plan_r, n, atol=atol,
                              connected=(ss.kind in ("constant",
                                                     "chebyshev")))


def schedule_spectral_lambda(sched: MixSchedule, n: int | None = None,
                             rounds: int = 1) -> np.ndarray:
    """Per-round lambda = ||W^t - J|| over the first ``rounds`` rounds:
    (rounds,) for unswept schedules, (S, rounds) for swept ones."""
    if sched.is_stacked:
        return np.stack([schedule_spectral_lambda(sched.point(s), n, rounds)
                         for s in range(sched.n_sweep)])
    return np.asarray([spectral_lambda(_host_W(sched.plan_at(r), n))
                       for r in range(rounds)])
