"""Execution backends: how a mixing operand runs on a placement.

Port of ``repro/training/backends.py``.  A backend answers one question —
how does a :class:`~repro_torch.core.mixing.MixPlan` or
:class:`~repro_torch.core.schedule.MixSchedule` execute here — so the round
program, the sweep engine and the trainers share it.

* :class:`StackedVmapBackend` (``"stacked-vmap"``) keeps every client
  variable on a leading dim and mixes with plain tensor products, for one
  configuration (``(C, ...)`` leaves) or a sweep (``(S, C, ...)``).
* :class:`ShardMapBackend` (``"shard_map"``) shards the client axis over a
  process group, one process a device.  The reference's ``shard_map`` is
  one SPMD program over global arrays; here **each process holds its
  contiguous block of ``n / P`` client rows** (``(S, n / P, ...)`` in a
  sweep; :attr:`ShardMapBackend.rows`), and the contract is:

  - the round program (``step``, ``local_then_comm_round``) runs unchanged
    on a process's rows, the fused sweep kernels included;
  - only mixing, and what reduces over clients (the metrics, the logged
    loss, the consensus model), crosses the group: ``pmean`` for complete,
    one ``ppermute`` per circulant offset, ``all_gather`` + this shard's
    rows of W for dense (:func:`~repro_torch.core.mixing.shard_body`,
    :func:`~repro_torch.core.schedule.shard_schedule_body`);
  - whatever is drawn for all clients (cohort masks, async staleness
    weights, the batches a trainer's iterator yields) is drawn whole on
    every process, which takes its rows; a caller driving ``sweep_run`` /
    ``step`` directly hands each process its own rows of the data (the
    grad_fn sees them only).

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
:class:`StackedVmapBackend`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Protocol, runtime_checkable

import torch.distributed as dist

from repro_torch.core.mixing import apply_mix, apply_mix_sweep, shard_mixer
from repro_torch.core.schedule import (
    MixSchedule,
    ScheduleMixer,
    apply_schedule,
    apply_schedule_sweep,
    shard_schedule_mixer,
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
class ShardMapBackend:
    """The client axis sharded over ``axis_name`` of ``mesh`` (a
    :class:`~repro_torch.launch.mesh.Mesh` over the live process group).

    ``n_clients`` is the *global* client count (the padded one for a
    cohort schedule; 0: one client a process).  Circulant plans need one
    client per process on the axis (the ppermute schedule is per shard);
    dense and complete plans take any equal block size.  Each process
    holds :attr:`rows` of every client variable.  ``axis_wrapper`` wraps
    the mesh's axis before any mixer sees it (``analysis.hlo.CountingAxis``
    counts the collectives; None: the axis as it is).
    """

    mesh: Any
    axis_name: Any = "clients"
    n_clients: int = 0
    axis_wrapper: Optional[Callable] = None
    name: str = dataclasses.field(default="shard_map", init=False)
    #: the fused local update runs on this process's client rows, outside
    #: the collectives: per-shard client tiles, the same kernels
    supports_fused_sweep: bool = dataclasses.field(default=True, init=False)

    @functools.cached_property
    def axis(self):
        """This process's :class:`~repro_torch.launch.mesh.ShardAxis`."""
        axis = self.mesh.axis(self.axis_name)
        return axis if self.axis_wrapper is None else self.axis_wrapper(axis)

    @property
    def global_clients(self) -> int:
        return self.n_clients or self.axis.size

    @property
    def rows(self) -> slice:
        """This process's block of the global client axis."""
        return self.axis.rows(self.global_clients)

    def _check_plan(self, plan) -> None:
        size = self.axis.size
        n = self.global_clients
        if n % size != 0:
            raise ValueError(
                f"n_clients={n} not divisible by mesh axis "
                f"{self.axis_name!r} of size {size}")
        if _plan_kind(plan) == "circulant" and n != size:
            raise ValueError(
                "circulant (ppermute) plans need one client per device; "
                f"got n_clients={n} on a {size}-way axis — use a dense plan")

    def mixer_for(self, plan, *, sweep: bool = False) -> Mixer:
        """``shard_mixer`` for a plan; for a schedule, the round-indexed
        ``shard_schedule_mixer`` (with ``wire_fn`` where its compressed
        increments pack: ``q`` crosses the group as value / index pairs
        or int8 words)."""
        if isinstance(plan, MixSchedule):
            self._check_plan(plan)
            return shard_schedule_mixer(plan, self.axis, self.rows,
                                        sweep=sweep)
        if plan.kind != "identity":
            self._check_plan(plan)
        return shard_mixer(plan, self.axis, sweep=sweep)


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
                    devices=None, axis_name: str = "clients",
                    param_dim: int | None = None) -> ExecutionBackend:
    """The backend :func:`suggest_backend_name` picks for the plan's
    sparsity on ``devices`` (a sequence; default: one device a process of
    the initialised process group, else one).  ``param_dim`` (flattened
    per-client parameter count) lets a compressed schedule's payload
    refine the choice.  Where the rule picks shard_map, the client axis
    shards over every process of the live group (one-axis mesh named
    ``axis_name``); that needs ``devices`` to count the group's processes.
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
        from repro_torch.launch.mesh import make_client_mesh

        if n_devices != _process_devices():
            raise ValueError(
                f"shard_map over {n_devices} devices needs a process group "
                f"of {n_devices} processes (one a device); this one has "
                f"{_process_devices()}")
        return ShardMapBackend(mesh=make_client_mesh(axis_name),
                               axis_name=axis_name, n_clients=n_clients)
    return StackedVmapBackend()


def get_backend(name: str, *, mesh=None, axis_name: str = "clients",
                n_clients: int = 0,
                inner: Optional[ExecutionBackend] = None) -> ExecutionBackend:
    """Build a backend by its protocol name."""
    if name == "stacked-vmap":
        return StackedVmapBackend()
    if name == "shard_map":
        if mesh is None:
            raise ValueError("shard_map backend needs a mesh")
        return ShardMapBackend(mesh=mesh, axis_name=axis_name,
                               n_clients=n_clients)
    if name == "sweep":
        return SweepBackend(inner=inner or StackedVmapBackend())
    raise KeyError(
        f"unknown backend {name!r}; have stacked-vmap | shard_map | sweep")
