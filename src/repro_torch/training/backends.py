"""Execution backends: how a mixing operand runs on a placement.

Port of the stacked-clients part of ``repro/training/backends.py``: the
:class:`ExecutionBackend` protocol, :class:`StackedVmapBackend` and
``_plan_kind``.  A backend answers one question — how does a
:class:`~repro_torch.core.mixing.MixPlan` or
:class:`~repro_torch.core.schedule.MixSchedule` execute here — so the round
program and the sweep engine share it.  ``StackedVmapBackend`` keeps every
client variable on a leading dim and mixes with plain tensor products, for
one configuration (``(C, ...)`` leaves) or a sweep (``(S, C, ...)``).

The local update is orthogonal to the mixing: with the ``fused`` knob the
round program's update is one grouped launch of the sweep kernels for all
``(S, C)`` rows, whatever the backend; ``supports_fused_sweep`` lets a
placement opt out.  ``ShardMapBackend``, ``SweepBackend`` and
``suggest_backend*`` (process-group collectives) wait for the backends
slice (ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Protocol, runtime_checkable

from repro_torch.core.mixing import apply_mix, apply_mix_sweep
from repro_torch.core.schedule import (
    MixSchedule,
    ScheduleMixer,
    apply_schedule,
    apply_schedule_sweep,
)

Mixer = Callable[[Any], Any]


def _plan_kind(plan_or_schedule) -> str:
    """Effective collective kind: a schedule's base plan, a chebyshev
    plan's base — what decides ppermute against all_gather on a sharded
    placement.  Cohort schedules resolve to their padded dense base."""
    plan = (plan_or_schedule.plan if isinstance(plan_or_schedule, MixSchedule)
            else plan_or_schedule)
    return plan.base_kind if plan.kind == "chebyshev" else plan.kind


@runtime_checkable
class ExecutionBackend(Protocol):
    """The contract every backend satisfies."""

    name: str
    #: Whether the round program's fused sweep kernels may run on this
    #: placement; ``training.sweep`` consults it before honouring
    #: ``fused="require"``.
    supports_fused_sweep: bool

    def mixer_for(self, plan, *, sweep: bool = False) -> Mixer:
        """A mixer for ``plan`` over ``(C, ...)`` leaves, or over
        ``(S, C, ...)`` leaves with ``sweep``."""
        ...  # pragma: no cover


@dataclasses.dataclass(frozen=True)
class StackedVmapBackend:
    """Simulation: a leading client dim (after the sweep dim, if any),
    tensor-product mixing.

    ``mixer_for`` returns a plain mixer for a :class:`MixPlan` and a
    :class:`~repro_torch.core.schedule.ScheduleMixer` (``mix(tree, r)``,
    driven by the round program from ``t // T0``) for a schedule.
    """

    name: str = dataclasses.field(default="stacked-vmap", init=False)
    supports_fused_sweep: bool = dataclasses.field(default=True, init=False)

    def mixer_for(self, plan, *, sweep: bool = False) -> Mixer:
        if isinstance(plan, MixSchedule):
            fn = apply_schedule_sweep if sweep else apply_schedule
            return ScheduleMixer(lambda tree, r: fn(plan, r, tree), plan)
        fn = apply_mix_sweep if sweep else apply_mix
        return lambda tree: fn(plan, tree)
