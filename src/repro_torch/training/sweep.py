"""Sweep engine: S configurations of a DEPOSITUM run as one program.

Port of ``repro/training/sweep.py``.  The paper's experimental section
(Figs. 3-7) is a grid study over step sizes, momentum, regulariser
strength and, in Fig. 6, the topology itself.  The reference vmaps a whole
run over a stacked sweep axis; here the axis is explicit: every state leaf
is ``(S, C, ...)`` (S configurations, C clients), and one call of
``local_then_comm_round(..., sweep=True)`` advances all S at once.

* The fused update and tracking kernels take the ``(S, 5)`` table: one
  grouped launch a step for every ``(config, client)`` row (the
  reference's ``custom_vmap`` rule maps the sweep axis onto the kernels'
  grid axis 0 to the same end).
* The gossip of a stacked dense plan is one batched fp32 product a leaf;
  stacked circulant, chebyshev and round-indexed schedules (``(S, R,
  ...)``) mix per point; an unstacked plan or schedule is shared.
* Gradients are ``torch.func.vmap(grad_fn, in_dims=(0, batch_axis))``
  over the client ``grad_fn``.
* Metrics run per point on views of the state (eval, not the round).
* ``telemetry=`` records the in-loop theory metrics
  (:func:`repro_torch.obs.metrics.round_values`) of all S points from the
  one batched round into a device ring buffer, one stream a point
  (``config = s``), copied to the host once every B logged rows; the
  recorder only reads the post-round state, so trajectories are bit for
  bit those of a run without it.
* A schedule carrying a compression spec (a stacked mixed spec for a
  compressor grid) gives every point CHOCO error-feedback memory, the
  ``none`` point of a mixed grid included.

Shapes:
  hypers        Hyper with (S,) values, or unstacked (broadcast)
  mixer         a Mixer closure (shared; vmapped over the sweep axis), or
                a MixPlan / MixSchedule, stacked over S or shared
  batches       leaves (rounds, T0, C, B, ...) shared across the sweep, or
                with an (S,) axis at ``batch_axis``
  final state   leaves (S, C, ...)
  round outputs leaves (S, rounds)

:func:`sweep_run_sequential` runs each point through the one-config round
program, so the engine's equivalence tests compare two real code paths.
Static structure (momentum kind, prox family, T0, the ``fused`` policy)
lives in the one ``DepositumConfig`` the sweep shares.

:func:`sweep_run_fedalg` runs a fedopt baseline (Table III) over the same
sweep axis.

``backend=`` a :class:`~repro_torch.training.backends.ShardMapBackend`
runs every point on this process's block of the client axis (``(S,
C / P, ...)`` leaves): the grad_fn and the batches are this process's
rows, the mixing and the recorder's reductions cross the group.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Iterable, Iterator, Optional

import torch
from torch.func import vmap

from repro_torch.core.compression import CommMemory
from repro_torch.core.depositum import (
    _KERNEL_DTYPES,
    DepositumConfig,
    DepositumState,
    fused_eligibility,
    init as dep_init,
    initial_comm,
    local_then_comm_round,
)
from repro_torch.core.hyper import Hyper, n_sweep, stack_hypers
from repro_torch.core.mixing import MixPlan, validate_plan
from repro_torch.core.schedule import MixSchedule, validate_schedule
from repro_torch.launch.mesh import LOCAL_AXIS, client_axis
from repro_torch.obs.metrics import round_values
from repro_torch.training.backends import ExecutionBackend, StackedVmapBackend

GradFn = Callable[[Any, Any], tuple[Any, Any]]
MetricsFn = Callable[[DepositumState, Hyper], dict]
_FIELDS = ("x", "y", "nu", "mu", "g")


def _map(fn, *trees):
    """``fn`` on every tensor of a dict tree (or on a bare tensor); with
    several trees of one structure, on their matching tensors."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _first(tree) -> torch.Tensor:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


# ---------------------------------------------------------------------------
# Data adapters: one data stream across the sweep axis
# ---------------------------------------------------------------------------

def broadcast_batches(batches, n: int):
    """A leading sweep dim of length ``n`` on every leaf: an ``expand``
    view, no copy."""
    return _map(lambda b: b[None].expand((n,) + tuple(b.shape)), batches)


def sweep_batch_iter(base_iter: Iterator, n: int) -> Iterator:
    """Adapter for streaming loops: yields each batch with a sweep dim."""
    for batches in base_iter:
        yield broadcast_batches(batches, n)


def stack_rounds(batch_list: Iterable):
    """Stack per-round batch trees into one (rounds, ...) tree."""
    batch_list = list(batch_list)
    if isinstance(batch_list[0], dict):
        return {k: stack_rounds([b[k] for b in batch_list])
                for k in batch_list[0]}
    return torch.stack(batch_list)


# ---------------------------------------------------------------------------
# Sweep operands: (mixer | MixPlan | MixSchedule) + Hyper -> sweep length
# ---------------------------------------------------------------------------

def _mapped_len(tree, axis: Optional[int]) -> int:
    """Sweep-dim length of a tree mapped at ``axis`` (1 when unmapped)."""
    if axis is None:
        return 1
    return int(_first(tree).shape[axis])


def _take(tree, s: int, axis: Optional[int]):
    """Sweep point ``s`` of a tree mapped at ``axis`` (itself if None)."""
    if axis is None:
        return tree
    return _map(lambda v: v.select(axis, s), tree)


def _normalise_operands(mixer, hypers: Hyper, n_extra: int = 1):
    """Returns (legacy_mixer, plan, hypers, S).

    Exactly one of ``legacy_mixer`` / a real plan is active: a Mixer
    closure rides along (the plan is then the identity), a MixPlan or
    MixSchedule is the sweep operand.  Unstacked operands broadcast;
    stacked ones must agree on S (they are zipped).  ``n_extra`` is the
    sweep length implied by ``params_axis`` / ``batch_axis``.  A sweep with
    nothing stacked is one point with a stacked Hyper.
    """
    if isinstance(mixer, (MixPlan, MixSchedule)):
        legacy, plan = None, mixer
    else:
        legacy, plan = mixer, MixPlan.identity()
    S_h = n_sweep(hypers)
    hyper_stacked = torch.as_tensor(hypers.alpha).ndim > 0
    S_p = plan.n_sweep
    S = max(S_h if hyper_stacked else 1, S_p, n_extra)
    for name, stacked, length in (("Hyper", hyper_stacked, S_h),
                                  ("MixPlan/MixSchedule", plan.is_stacked,
                                   S_p),
                                  ("params/batches", n_extra > 1, n_extra)):
        if stacked and length != S:
            raise ValueError(
                f"stacked {name} axis ({length}) disagrees with the sweep "
                f"length {S} (stacked operands are zipped and must match)")
    if not hyper_stacked and not plan.is_stacked and S == 1:
        hypers = stack_hypers([hypers])
    return legacy, plan, hypers, S


def _validate_operand(plan, n_clients: int) -> None:
    """Assumption-2 gate for either mixing operand form."""
    if isinstance(plan, MixSchedule):
        validate_schedule(plan, n_clients)
    else:
        validate_plan(plan, n_clients)


def _check_fused_boundary(config: DepositumConfig, params0=None,
                          backend=None) -> None:
    """``fused="require"`` checked on the host at the sweep boundary, with
    the structural reason (momentum kind, prox family, params dtype, a
    backend opting out), before any step runs."""
    if config.fused_mode() != "require":
        return
    ok, why = fused_eligibility(config)
    if ok and backend is not None and not getattr(
            backend, "supports_fused_sweep", True):
        ok, why = False, f"backend {backend.name!r} opts out of fused sweep"
    if ok and params0 is not None:
        leaves = []
        _map(leaves.append, params0)
        for leaf in leaves:
            if leaf.dtype not in _KERNEL_DTYPES:
                ok, why = False, (f"params leaf dtype {leaf.dtype} (kernel "
                                  "takes float32 | bfloat16)")
                break
    if not ok:
        raise ValueError(f"fused='require' cannot be honoured: {why}")


def _metrics_caller(metrics_fn):
    """A metrics callback as ``f(state, hyper, operand) -> dict``: the
    classic ``metrics_fn(state, hyper)`` stays supported; a third
    parameter receives the point's mixing operand (cohort metrics reduce
    over its sampler's eligible rows)."""
    if metrics_fn is None:
        return None
    try:
        params = [p for p in inspect.signature(metrics_fn).parameters.values()
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
        wants_plan = len(params) >= 3
    except (TypeError, ValueError):   # builtins without a signature
        wants_plan = False
    if wants_plan:
        return metrics_fn
    return lambda state, hyper, plan: metrics_fn(state, hyper)


def _hyper_point(hypers: Hyper, s: int) -> Hyper:
    if torch.as_tensor(hypers.alpha).ndim == 0:
        return hypers
    return Hyper(*(v[s] for v in hypers))


def _state_point(state: DepositumState, s: int) -> DepositumState:
    point = lambda tree: {k: v[s] for k, v in tree.items()}
    comm = {v: CommMemory(*(point(t) for t in mem))
            for v, mem in state.comm.items()} if state.comm else ()
    return DepositumState(*(point(getattr(state, f)) for f in _FIELDS),
                          t=state.t, comm=comm)


def _stack_outs(per_point: list) -> dict:
    """[point][round] dicts of 0-d tensors -> {name: (S, rounds)}."""
    if not per_point or not per_point[0]:
        return {}
    return {k: torch.stack([torch.stack([m[k] for m in rows])
                            for rows in per_point])
            for k in per_point[0][0]}


def _sweep_grad(grad_fn: GradFn, batch_axis: Optional[int]) -> GradFn:
    """The client ``grad_fn`` over ``(S, C, ...)`` leaves: vmapped over the
    sweep axis, the batch shared (``batch_axis`` None) or per point."""
    return vmap(grad_fn, in_dims=(0, None if batch_axis is None else 0))


def _sweep_mixer(legacy, plan, backend: ExecutionBackend):
    """The mixer of a sweep round: a shared closure vmapped over the sweep
    axis, else the backend's sweep mixer for the plan or schedule."""
    if legacy is not None:
        return vmap(legacy)
    return backend.mixer_for(plan, sweep=True)


def _sweep_x(params0, n_clients: int, n: int,
             params_axis: Optional[int] = None) -> dict:
    """x of a sweep's initial state: leaves (n, n_clients, ...), the same
    for every client (and, unless ``params_axis`` maps per-point initial
    params, for every point)."""

    def x_leaf(p):
        if params_axis is None:
            p = p[None].expand((n,) + tuple(p.shape))
        else:
            p = p.movedim(params_axis, 0)
        return p[:, None].expand(
            (n, n_clients) + tuple(p.shape[1:])).clone()

    return {k: x_leaf(v) for k, v in params0.items()}


def sweep_init(params0, n_clients: int, n: int, compress: Any = None, *,
               params_axis: Optional[int] = None,
               backend=None) -> DepositumState:
    """Initial sweep state: leaves (n, n_clients, ...) on ``params0``'s
    device, x the same for every client (and, unless ``params_axis`` maps
    per-point initial params, for every point); auxiliaries zero.

    ``compress`` (a CompressionSpec or a schedule carrying one) allocates
    the CHOCO memory on every point, as :func:`sweep_run` does: pass the
    swept schedule here when driving :func:`make_sweep_round` by hand.
    ``backend`` sharding the client axis: this process's rows only."""
    rows = client_axis(backend).rows(n_clients)
    x = _sweep_x(params0, rows.stop - rows.start, n, params_axis)
    z = lambda: {k: torch.zeros_like(v) for k, v in x.items()}
    return DepositumState(x=x, y=z(), nu=z(), mu=z(), g=z(), t=0,
                          comm=initial_comm(compress, x))


def make_sweep_round(grad_fn: GradFn, config: DepositumConfig, mixer, *,
                     batch_axis: Optional[int] = 0,
                     backend: Optional[ExecutionBackend] = None) -> Callable:
    """One federated round over the sweep axis, for streaming loops.

    Returns ``round_fn(states, hypers, batches, plan=None) -> (states,
    aux)`` with state leaves ``(S, C, ...)``.  ``mixer`` may be a Mixer
    closure or a (possibly stacked) MixPlan / MixSchedule; a compressing
    schedule needs states from ``sweep_init(..., compress=schedule)``.
    The plan is an operand of each call: ``plan=`` swaps in another
    same-structure plan (a new topology grid, a reseeded cohort, another
    compressor grid) for that round.  ``hypers``
    may be stacked or unstacked (broadcast).  ``batch_axis=0`` matches
    :func:`broadcast_batches` / :func:`sweep_batch_iter` (leaves (S, T0,
    C, ...)); ``batch_axis=None`` takes (T0, C, ...) batches shared by the
    sweep.
    """
    backend = backend or StackedVmapBackend()
    _check_fused_boundary(config, backend=backend)
    legacy, plan0, _, _ = _normalise_operands(mixer, Hyper.create())
    sgrad = _sweep_grad(grad_fn, batch_axis)

    def round_fn(states, hypers, batches, plan=None):
        dev = _first(states.x).device
        plan_arg = plan0 if plan is None else plan
        mix = _sweep_mixer(legacy, None if legacy is not None
                           else plan_arg.to(dev), backend)
        if batch_axis is not None:
            batches = _map(lambda v: v.movedim(batch_axis, 1), batches)
        return local_then_comm_round(states, batches, sgrad, config, mix,
                                     hyper=hypers, sweep=True)

    return round_fn


def _prepare(params0, config, mixer, hypers, batches, n_clients,
             batch_axis, params_axis, backend):
    """What :func:`sweep_run` and :func:`sweep_run_sequential` share: the
    host-side checks, the operands on ``params0``'s device, the round
    count."""
    backend = backend or StackedVmapBackend()
    config.validate(hypers)
    _check_fused_boundary(config, params0, backend)
    n_extra = max(_mapped_len(params0, params_axis),
                  _mapped_len(batches, batch_axis))
    legacy, plan, hypers, S = _normalise_operands(mixer, hypers, n_extra)
    dev = _first(params0).device
    if legacy is None:
        _validate_operand(plan, n_clients)
        plan = plan.to(dev)
    batches = _map(lambda v: v.to(dev), batches)
    rounds = _first(batches).shape[1 if batch_axis == 0 else 0]
    return backend, legacy, plan, hypers, S, batches, rounds


def _recorder(telemetry, config, hypers, plan, n_clients: int,
              log_every: int, rounds: int, device, S: Optional[int], *,
              tag=None, axis=LOCAL_AXIS):
    """``record(state, aux, r)`` of a run with ``telemetry`` (None
    without): the post-round state's :func:`~repro_torch.obs.metrics.
    round_values` into a device buffer (one ring a point when ``S``), the
    final round always.  The Hyper is put on the device once here."""
    if telemetry is None:
        return None
    hp = Hyper(*(torch.as_tensor(v, dtype=torch.float32).to(device)
                 for v in hypers))
    carry = telemetry.init_carry(S, device=device)

    def record(state, aux, r):
        nonlocal carry
        vals = round_values(state, config, hyper=hp, mixer=plan, aux=aux,
                            n=n_clients, sweep=S is not None, axis=axis)
        carry = telemetry.record_and_emit(
            carry, vals, (state.t - 1) // config.comm_period, log_every,
            tag=tag, force=r == rounds - 1)

    return record


def sweep_run(
    params0,
    grad_fn: GradFn,
    config: DepositumConfig,
    mixer,
    hypers: Hyper,
    batches,
    *,
    n_clients: int,
    metrics_fn: Optional[MetricsFn] = None,
    batch_axis: Optional[int] = None,
    params_axis: Optional[int] = None,
    backend: Optional[ExecutionBackend] = None,
    telemetry=None,
    log_every: int = 1,
) -> tuple[DepositumState, dict]:
    """Run every round for every sweep point at once.

    ``mixer``: a Mixer closure (one topology for the sweep), a MixPlan or a
    MixSchedule; a stacked one (dense W (S, n, n), schedules (S, R, ...))
    makes the topology or the schedule a sweep dimension, zipped with the
    Hyper axis.  ``batches`` leaves (rounds, T0, C, B, ...) are shared
    (``batch_axis=None``) or carry an (S,) dim at ``batch_axis``;
    ``params_axis`` likewise sweeps the initial params (per-seed runs).
    Runs on ``params0``'s device.  Returns the final state (leaves (S, C,
    ...)) and the per-round metrics ``{name: (S, rounds)}`` (empty without
    ``metrics_fn``).

    ``telemetry`` (a :class:`~repro_torch.obs.record.Telemetry`) records
    the theory metrics of every point from each batched round at the
    cadence ``log_every`` (the final round always), one event stream a
    point (``config = s``); the run ends with ``telemetry.sync()``.
    """
    backend, legacy, plan, hypers, S, batches, rounds = _prepare(
        params0, config, mixer, hypers, batches, n_clients, batch_axis,
        params_axis, backend)
    if batch_axis is not None:                 # rounds first: (R, T0, S, ..)
        batches = _map(lambda v: v.movedim(batch_axis, 2), batches)
    if torch.as_tensor(hypers.alpha).ndim == 0:
        hypers = Hyper(*(torch.as_tensor(v).expand(S) for v in hypers))
    state = sweep_init(params0, n_clients, S, params_axis=params_axis,
                       compress=plan, backend=backend)
    sgrad = _sweep_grad(grad_fn, batch_axis)
    mix = _sweep_mixer(legacy, plan, backend)
    metrics = _metrics_caller(metrics_fn)
    record = _recorder(telemetry, config, hypers, plan, n_clients,
                       log_every, rounds, _first(params0).device, S,
                       axis=client_axis(backend))
    per_point = [[] for _ in range(S)]
    for r in range(rounds):
        state, aux = local_then_comm_round(
            state, _map(lambda v: v[r], batches), sgrad, config, mix,
            hyper=hypers, sweep=True)
        if record is not None:
            record(state, aux, r)
        if metrics is not None:
            for s in range(S):
                per_point[s].append(metrics(_state_point(state, s),
                                            _hyper_point(hypers, s),
                                            plan.point(s)))
    if telemetry is not None:
        telemetry.sync()
    return state, _stack_outs(per_point)


def sweep_run_sequential(
    params0,
    grad_fn: GradFn,
    config: DepositumConfig,
    mixer,
    hypers: Hyper,
    batches,
    *,
    n_clients: int,
    metrics_fn: Optional[MetricsFn] = None,
    batch_axis: Optional[int] = None,
    params_axis: Optional[int] = None,
    backend: Optional[ExecutionBackend] = None,
    telemetry=None,
    log_every: int = 1,
) -> tuple[DepositumState, dict]:
    """Reference path: the same computation one sweep point at a time,
    each through the one-config round program (``(C, ...)`` leaves, its
    own grouped launches), re-stacked on the sweep axis.  Used by the
    equivalence tests and the sweep-vs-sequential wall-clock ratio.
    ``telemetry`` records each point's stream (``config = s``) from its own
    one-config rounds."""
    backend, legacy, plan, hypers, S, batches, rounds = _prepare(
        params0, config, mixer, hypers, batches, n_clients, batch_axis,
        params_axis, backend)
    dev = _first(params0).device
    metrics = _metrics_caller(metrics_fn)
    finals, per_point = [], []
    for s in range(S):
        hyper_s, plan_s = _hyper_point(hypers, s), plan.point(s)
        mixer_s = legacy if legacy is not None else backend.mixer_for(plan_s)
        batches_s = _take(batches, s, batch_axis)
        state = dep_init(_take(params0, s, params_axis), n_clients,
                         compress=plan_s, device=dev, backend=backend)
        record = _recorder(telemetry, config, hyper_s, plan_s, n_clients,
                           log_every, rounds, dev, None, tag=s,
                           axis=client_axis(backend))
        outs = []
        for r in range(rounds):
            state, aux = local_then_comm_round(
                state, _map(lambda v: v[r], batches_s), grad_fn, config,
                mixer_s, hyper=hyper_s)
            if record is not None:
                record(state, aux, r)
            if metrics is not None:
                outs.append(metrics(state, hyper_s, plan_s))
        if telemetry is not None:
            telemetry.sync()
        finals.append(state)
        per_point.append(outs)
    stack = lambda trees: {k: torch.stack([t[k] for t in trees])
                           for k in trees[0]}
    comm = finals[0].comm and {
        v: CommMemory(*(stack([f.comm[v][i] for f in finals])
                        for i in range(2))) for v in ("x", "y")}
    final = DepositumState(
        *(stack([getattr(f, name) for f in finals]) for name in _FIELDS),
        t=finals[0].t, comm=comm)
    return final, _stack_outs(per_point)


# ---------------------------------------------------------------------------
# Fedopt baselines through the same engine (Table III grids)
# ---------------------------------------------------------------------------

def sweep_run_fedalg(
    alg,
    params0,
    grad_fn: GradFn,
    hypers: Hyper,
    batches,
    *,
    n_clients: int,
    metrics_fn=None,
    batch_axis: Optional[int] = None,
    params_axis: Optional[int] = None,
    plan=None,
    backend: Optional[ExecutionBackend] = None,
) -> tuple[Any, dict]:
    """A fedopt baseline's whole run over the sweep axis (Table III).

    ``alg`` is a :mod:`repro_torch.core.fedopt` algorithm; its ``round``
    takes the same ``hyper`` override (and a decentralized algorithm the
    same ``plan``) as DEPOSITUM, so a baseline grid runs as one program
    like the DEPOSITUM grids: every round advances all S points on ``(S,
    C, ...)`` leaves, the local SGD steps through the vmapped client
    ``grad_fn``.  ``batches`` leaves (rounds, T0, C, B, ...), optionally
    with an (S,) dim at ``batch_axis``; ``params_axis=0`` sweeps the
    initialisation (Table III's per-seed runs).  A scalar Hyper broadcasts
    over whatever defines the sweep axis.  Runs on ``params0``'s device.
    Returns the final ``FedState`` (leaves (S, C, ...)) and the per-round
    metrics ``{name: (S, rounds)}``.  ``backend`` sharding the client axis
    runs each process's rows: the server means reduce over the group and
    a decentralized baseline gossips through the backend.
    """
    dev = _first(params0).device
    if plan is not None:
        # the same Assumption-2 gate as sweep_run: baseline grids must not
        # silently run an invalid W
        _validate_operand(plan, n_clients)
        plan = plan.to(dev)
    n_extra = max(_mapped_len(params0, params_axis),
                  _mapped_len(batches, batch_axis))
    _, plan_arg, hypers, S = _normalise_operands(
        plan if plan is not None else MixPlan.identity(), hypers, n_extra)
    if torch.as_tensor(hypers.alpha).ndim == 0:
        hypers = Hyper(*(torch.as_tensor(v).expand(S) for v in hypers))
    batches = _map(lambda v: v.to(dev), batches)
    rounds = _first(batches).shape[1 if batch_axis == 0 else 0]
    if batch_axis is not None:                 # rounds first: (R, T0, S, ..)
        batches = _map(lambda v: v.movedim(batch_axis, 2), batches)
    rows = client_axis(backend).rows(n_clients)
    state = alg.init_stacked(_sweep_x(params0, rows.stop - rows.start, S,
                                      params_axis))
    sgrad = _sweep_grad(grad_fn, batch_axis)
    kw = {"plan": plan_arg} if plan is not None else {}
    if backend is not None:
        kw["backend"] = backend
    metrics = _metrics_caller(metrics_fn)
    per_point = [[] for _ in range(S)]
    for r in range(rounds):
        state, _ = alg.round(state, _map(lambda v: v[r], batches), sgrad,
                             hyper=hypers, sweep=True, **kw)
        if metrics is not None:
            for s in range(S):
                point = state._replace(**{f: {k: v[s] for k, v in
                                              getattr(state, f).items()}
                                          for f in ("x", "aux1", "aux2")})
                per_point[s].append(metrics(point, _hyper_point(hypers, s),
                                            plan_arg.point(s)))
    return state, _stack_outs(per_point)
