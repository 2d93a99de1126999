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
placement opt out.

:class:`SweepBackend` (``"sweep"``) runs whole grids: ``run`` forwards to
:func:`repro_torch.training.sweep.sweep_run` with its ``inner`` backend.
:func:`suggest_backend_name` is the reference's pure selection rule;
:func:`suggest_backend` applies it to this process.  One process drives
one device, so ``n_devices`` is the ``torch.distributed`` world size when
a process group is initialised, else 1, and a single process always gets
:class:`StackedVmapBackend`.  ``ShardMapBackend`` (the client axis sharded
over a process group: collective mixers, per-shard schedules) is ROADMAP
Queue 1 item 5c; where the rule picks it, :func:`suggest_backend` and
``get_backend("shard_map")`` raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Protocol, runtime_checkable

import torch.distributed as dist

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


@dataclasses.dataclass(frozen=True)
class SweepBackend:
    """Grid semantics: whole runs over stacked Hyper / MixPlan axes.

    ``mixer_for`` delegates to the inner backend; ``run`` forwards to
    :func:`repro_torch.training.sweep.sweep_run` with ``backend=self.inner``
    so there is one implementation of the grid loop.
    """

    inner: ExecutionBackend = dataclasses.field(
        default_factory=StackedVmapBackend)
    name: str = dataclasses.field(default="sweep", init=False)

    @property
    def supports_fused_sweep(self) -> bool:
        return getattr(self.inner, "supports_fused_sweep", True)

    def mixer_for(self, plan, *, sweep: bool = False) -> Mixer:
        return self.inner.mixer_for(plan, sweep=sweep)

    def run(self, params0, grad_fn, config, mixer, hypers, batches, *,
            n_clients: int, metrics_fn=None, batch_axis=None,
            telemetry=None, log_every: int = 1):
        from repro_torch.training.sweep import sweep_run

        return sweep_run(params0, grad_fn, config, mixer, hypers, batches,
                         n_clients=n_clients, metrics_fn=metrics_fn,
                         batch_axis=batch_axis, backend=self.inner,
                         telemetry=telemetry, log_every=log_every)


#: Per-device bytes/round below which a comm round is latency-bound — the
#: collective costs more in dispatch than it moves, and the single-process
#: stacked simulation wins.  A deliberately conservative 4 KiB.
LATENCY_BYTES_FLOOR = 4096

_SHARD_MAP_TODO = ("the shard_map backend (the client axis sharded over a "
                   "torch.distributed process group) is ROADMAP Queue 1 "
                   "item 5c")


def suggest_backend_name(kind: str, n_clients: int, n_devices: int, *,
                         wire_bytes: float | None = None) -> str:
    """Pure decision rule for :func:`suggest_backend`.

    * circulant (incl. chebyshev-over-circulant) plans want the ppermute
      path, which needs exactly one client per device;
    * dense/complete plans want the all_gather/pmean path whenever the
      device count divides the client count;
    * anything else (single device, indivisible counts, identity) runs the
      stacked simulation.

    ``wire_bytes`` — per-round bytes one device puts on the wire, of the
    compressed payload (:func:`repro_torch.analysis.comm.
    device_wire_bytes`) — below :data:`LATENCY_BYTES_FLOOR` makes every
    collective latency-bound, so the simulation is preferred.  ``None``
    keeps the structural rule.
    """
    if n_devices > 1 and n_clients > 1:
        latency_bound = wire_bytes is not None and \
            wire_bytes < LATENCY_BYTES_FLOOR
        if kind == "circulant":
            if n_devices == n_clients and not latency_bound:
                return "shard_map"
            return "stacked-vmap"
        if kind in ("dense", "complete") and n_clients % n_devices == 0 \
                and not latency_bound:
            return "shard_map"
    return "stacked-vmap"


def _process_devices() -> int:
    """Devices this program drives: the process group's world size when
    one is initialised (one device a process), else 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def suggest_backend(plan_or_schedule, n_clients: int, *,
                    devices=None,
                    param_dim: int | None = None) -> ExecutionBackend:
    """The backend :func:`suggest_backend_name` picks for the plan's
    sparsity on ``devices`` (a sequence; default: one device a process
    of the initialised process group, else one).  ``param_dim`` (flattened per-client parameter count) lets
    a compressed schedule's payload refine the choice.  Raises
    ``NotImplementedError`` where the rule picks shard_map.
    """
    n_devices = len(devices) if devices is not None else _process_devices()
    wire_bytes = None
    if param_dim is not None and isinstance(plan_or_schedule, MixSchedule) \
            and plan_or_schedule.compress is not None \
            and not plan_or_schedule.is_stacked:
        from repro_torch.analysis.comm import device_wire_bytes

        wire_bytes = device_wire_bytes(plan_or_schedule, param_dim,
                                       n_clients, n_devices)
    name = suggest_backend_name(_plan_kind(plan_or_schedule), n_clients,
                                n_devices, wire_bytes=wire_bytes)
    if name == "shard_map":
        raise NotImplementedError(
            f"{n_clients} clients on {n_devices} devices want "
            f"{_SHARD_MAP_TODO}")
    return StackedVmapBackend()


def get_backend(name: str, *,
                inner: Optional[ExecutionBackend] = None) -> ExecutionBackend:
    """Build a backend by its protocol name (the shard_map backend, and
    its mesh arguments, are ROADMAP item 5c)."""
    if name == "stacked-vmap":
        return StackedVmapBackend()
    if name == "shard_map":
        raise NotImplementedError(_SHARD_MAP_TODO)
    if name == "sweep":
        return SweepBackend(inner=inner or StackedVmapBackend())
    raise KeyError(
        f"unknown backend {name!r}; have stacked-vmap | shard_map | sweep")
