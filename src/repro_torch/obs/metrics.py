"""In-loop theory metrics: what a DEPOSITUM round records (port of
``repro/obs/metrics.py``).

Theorem 1 bounds the running means of the proximal gradient mapping, the
consensus errors and the gradient estimation error; ``stationarity_metrics``
computes them only at eval points, with exact full-data gradients.  The
quantities below are cheap functions of the round program's own state (no
extra gradient, no host read), computed on the state's device after every
round:

* ``prox_grad_sq``   — ``(1/n) Σ_i ‖(x_i − prox_{αh}(x_i − α ν_i))/α‖²``,
  the gradient mapping along the momentum direction ν.
* ``consensus_x`` / ``consensus_y`` — ``(1/n) ‖(I − J) v‖²`` of the
  iterates and the tracking variable; bit-equal to
  ``stationarity_metrics``'s terms (the same ``consensus_error``).
* ``momentum_var``   — ``(1/n) ‖(I − J) ν‖²`` (``consensus_nu``).
* ``track_err``      — ``(1/n) Σ_i ‖y_i − β ḡ‖²`` with ḡ the client mean
  of the last stochastic gradients.
* ``cohort_size``    — clients active this round; ``n`` for full
  participation.
* ``wire_bytes``     — bytes on the wire of this round's gossip, the
  device twin of :mod:`repro_torch.analysis.comm` (the same rules; lazy
  and cohort rounds count the mask actually drawn).
* ``loss``           — the mean of the grad aux's ``"ce"``, else of its
  ``"loss"``, else NaN (NaN, not a missing key, keeps streams
  rectangular).
* ``staleness``      — mean age of the updates applied this round: 0.0 on
  every bulk-synchronous path (the async runtime passes its own).

Every value is an fp32 tensor on the state's device: 0-d for one
configuration, ``(S,)`` with ``sweep=True`` (state leaves ``(S, C,
...)``).  Leaves are reduced one at a time, so no whole-tree temporary is
held; on the sweep axis each leaf is reduced once for all S points (a
point's value agrees with the one-config value on that point's state to
float rounding, rtol 1e-6).
:mod:`repro_torch.obs.record` packs them in :data:`DEFAULT_METRICS` order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.analysis.comm import (
    INDEX_BYTES,
    QSGD_NORM_BYTES,
    QSGD_WORD_BYTES,
    VALUE_BYTES,
)
from repro_torch.core.compression import KIND_IDS, CompressionSpec
from repro_torch.core.depositum import (
    DepositumConfig,
    DepositumState,
    consensus_error,
)
from repro_torch.core.hyper import Hyper
from repro_torch.core.mixing import MixPlan
from repro_torch.core.prox import prox_apply
from repro_torch.core.schedule import (
    MixSchedule,
    ScheduleMixer,
    _active_mask,
    _plan_index,
)
from repro_torch.launch.mesh import LOCAL_AXIS

Tree = dict

#: Every in-loop metric the recorder knows, in buffer-column order.
DEFAULT_METRICS = ("prox_grad_sq", "consensus_x", "consensus_y",
                   "momentum_var", "track_err", "cohort_size",
                   "wire_bytes", "loss", "staleness")


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """Recorder structure: which metrics, how many device rows.

    ``names`` picks (and orders) the recorded columns; ``buffer`` is the
    number of logged rows held on the device between host copies.  The
    logging cadence is an argument of each ``record`` instead.
    """

    names: tuple = DEFAULT_METRICS
    buffer: int = 8

    def __post_init__(self):
        unknown = [n for n in self.names if n not in DEFAULT_METRICS]
        if unknown:
            raise ValueError(f"unknown metrics {unknown}; "
                             f"have {DEFAULT_METRICS}")
        if self.buffer < 1:
            raise ValueError(f"buffer must be >= 1, got {self.buffer}")

    @property
    def n_metrics(self) -> int:
        return len(self.names)


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Bytes on the wire, on the device: the twin of repro_torch.analysis.comm
# ---------------------------------------------------------------------------

def traced_payload_row_bytes(spec: Optional[CompressionSpec], d: int, *,
                             device=None) -> torch.Tensor:
    """Bytes one client row ships per collective, an fp32 tensor (``(S,)``
    for a stacked spec) on the spec's device (else ``device``).

    Mirrors :func:`repro_torch.analysis.comm.payload_row_bytes` rule for
    rule (dense f32 rows; value+index pairs at ``wire_k`` or ``ceil(rate
    d)``; int8 qsgd words + one norm; mixed kinds dispatch on
    ``kind_id``) with device ops, so nothing is read back.
    """
    d = int(d)
    dev = device
    if spec is not None and spec.kind != "none":
        dev = spec.ef_step.device
    dense = _f32(d * VALUE_BYTES, dev)
    if spec is None or spec.kind == "none":
        return dense

    def sparse_bytes():
        if spec.wire_k > 0:
            return _f32(min(spec.wire_k, d) * (VALUE_BYTES + INDEX_BYTES),
                        dev)
        rate = spec.rate.to(torch.float32)
        k = torch.clamp(torch.round(rate * d), 1, d)
        return k * (VALUE_BYTES + INDEX_BYTES)

    quant = _f32(d * QSGD_WORD_BYTES + QSGD_NORM_BYTES, dev)
    if spec.kind in ("topk", "randk"):
        return sparse_bytes()
    if spec.kind == "qsgd":
        return quant
    kid = torch.clamp(spec.kind_id.to(torch.int64), max=len(KIND_IDS) - 1)
    return torch.where(kid == KIND_IDS["none"], dense,
                       torch.where(kid == KIND_IDS["qsgd"], quant,
                                   sparse_bytes()))


def _offdiag_edges(W: torch.Tensor, atol: float = 1e-12) -> torch.Tensor:
    """Nonzero off-diagonal entries of ``W`` (``(..., n, n)``), summed over
    the last two dims."""
    off = W - torch.diag_embed(torch.diagonal(W, dim1=-2, dim2=-1))
    return torch.sum((torch.abs(off) > atol).to(torch.float32), dim=(-2, -1))


def traced_round_edges(sched: MixSchedule, r: int,
                       active_mask: Optional[torch.Tensor] = None, *,
                       sweep: bool = False) -> torch.Tensor:
    """Transmitting directed edges of round ``r``'s collective, on the
    device: :func:`repro_torch.analysis.comm.round_edges` with the mask
    actually drawn for lazy / cohort rounds (``active_mask``, else the
    schedule's own draw at ``r``).  ``sweep`` with a stacked schedule
    gives ``(S,)``."""
    plan = sched.plan
    if sched.kind in ("stacked", "alternating"):
        axis = 1 if sweep and sched.is_stacked else 0
        return _offdiag_edges(_plan_index(plan, sched._round_index(r),
                                          axis).W)
    base = plan.base_plan() if plan.kind == "chebyshev" else plan
    if base.kind == "identity":
        return torch.zeros((), dtype=torch.float32)
    lazy = sched.kind in ("lazy", "cohort")
    if lazy:
        a = (active_mask if active_mask is not None
             else _active_mask(sched, r, sweep)).to(torch.float32)
    if base.kind == "circulant":
        if not lazy:
            raise ValueError("constant circulant edge counts need n; use "
                             "traced_round_bytes(..., n=)")
        return sum(torch.sum(a * torch.roll(a, -off, dims=-1), dim=-1)
                   for off in base.offsets)
    if base.kind == "complete":
        raise ValueError("complete-plan edge counts need n; use "
                         "traced_round_bytes(..., n=)")
    if not lazy:
        return _offdiag_edges(base.W)
    W = base.W
    off = W - torch.diag_embed(torch.diagonal(W, dim1=-2, dim2=-1))
    mask = (torch.abs(off) > 1e-12).to(torch.float32)
    return torch.sum(mask * (a[..., :, None] * a[..., None, :]),
                     dim=(-2, -1))


def traced_round_bytes(sched, r: int, d: int, *,
                       active_mask: Optional[torch.Tensor] = None,
                       n: Optional[int] = None, n_vars: int = 2,
                       sweep: bool = False,
                       device=None) -> torch.Tensor:
    """Bytes on the wire for one comm round, an fp32 tensor on the
    operand's device: the device twin of :func:`repro_torch.analysis.comm.
    round_wire_bytes` (transmitting edges x per-row payload x collectives
    x mixed variables).  Accepts a :class:`MixSchedule`, a
    ``ScheduleMixer`` or a plain :class:`MixPlan`; ``n`` is needed only
    for plans whose edge count their tensors do not carry (complete,
    constant circulant); a legacy mixer closure gives NaN."""
    if isinstance(sched, ScheduleMixer):
        sched = sched.schedule
    if isinstance(sched, MixPlan):
        sched = MixSchedule(kind="constant", plan=sched)
    if not isinstance(sched, MixSchedule):
        return _f32(float("nan"), device)
    plan = sched.plan
    base = plan.base_plan() if plan.kind == "chebyshev" else plan
    collectives = max(1, plan.cheby_k) if plan.kind == "chebyshev" else 1
    if base.kind in ("complete", "circulant") and sched.kind not in (
            "lazy", "cohort"):
        if n is None:
            return _f32(float("nan"), device)
        edges = _f32(n * (n - 1) if base.kind == "complete"
                     else n * len(base.offsets), device)
    else:
        edges = traced_round_edges(sched, r, active_mask, sweep=sweep)
    edges = edges.to(device) if device is not None else edges
    per_row = traced_payload_row_bytes(sched.compress, d,
                                       device=edges.device)
    return edges * per_row * _f32(collectives * n_vars, edges.device)


# ---------------------------------------------------------------------------
# The per-round values
# ---------------------------------------------------------------------------

def _loss_from_aux(aux, device, sweep: bool = False,
                   axis=LOCAL_AXIS) -> torch.Tensor:
    """Scalar training loss from a grad aux, NaN when unavailable:
    ``aux["ce"]`` wins, ``aux["loss"]`` is the fallback.  On the sweep axis
    the mean is taken per point (every dim after the first)."""
    v = None
    if isinstance(aux, dict):
        for key in ("ce", "loss"):
            cand = aux.get(key)
            if isinstance(cand, torch.Tensor) and cand.is_floating_point():
                v = cand
                break
    elif isinstance(aux, torch.Tensor) and aux.is_floating_point():
        v = aux
    if v is None:
        return _f32(float("nan"), device)
    # this shard's clients' losses: the mean over every shard's
    v = v.detach().to(torch.float32)
    if sweep and v.ndim > 0:
        return axis.client_mean(v.reshape(v.shape[0], -1), 1)
    return axis.client_mean(v.reshape(-1))


def _point_sum(v: torch.Tensor, sweep: bool) -> torch.Tensor:
    """The full sum of one leaf (0-d), or of each point's slice of it
    (``(S,)``) in one reduction."""
    if not sweep:
        return torch.sum(v)
    return torch.sum(v.reshape(v.shape[0], -1), dim=1)


def _weighted_sq(v: torch.Tensor, weights, sweep: bool,
                 axis=LOCAL_AXIS) -> torch.Tensor:
    """``Σ ‖v‖²`` over one leaf (per point on the sweep axis), rows
    weighted by ``weights`` ((n,) or (S, n)), as ``depositum._sq_norm``.
    ``axis``: the leaf holds this shard's rows of a sharded client axis;
    the sum is over every shard's (``weights`` global)."""
    sq = torch.square(v.to(torch.float32))
    if weights is None:
        total = _point_sum(sq, sweep)
    else:
        lead = 2 if sweep else 1
        per_client = torch.sum(sq.reshape(sq.shape[:lead] + (-1,)), dim=-1)
        w = axis.take(weights.to(torch.float32), -1)
        if not sweep:
            total = torch.sum(w * per_client)
        else:
            total = torch.sum(w.expand(per_client.shape) * per_client,
                              dim=-1)
    return axis.psum(total)


def _consensus(tree: Tree, weights, sweep: bool,
               axis=LOCAL_AXIS) -> torch.Tensor:
    """``consensus_error`` (per point on the sweep axis), leaf by leaf."""
    if not sweep:
        return consensus_error(tree, weights, axis)
    total = 0
    for v in tree.values():
        mean = axis.client_mean(v, 1, weights)
        total = total + _weighted_sq(v - mean[:, None], weights, True, axis)
    return total


def _n_clients(state, weights, sweep: bool, axis=LOCAL_AXIS):
    """n as ``stationarity_metrics`` divides by: the client count (an int;
    every shard's) or the weights' sum (per point on the sweep axis)."""
    if weights is None:
        return next(iter(state.x.values())).shape[1 if sweep else 0] \
            * axis.size
    return torch.sum(weights.to(torch.float32), dim=-1)


def _hp(config: DepositumConfig, hyper: Optional[Hyper], device) -> Hyper:
    """The Hyper (the config's when None) on the state's device."""
    hp = config.hyper() if hyper is None else hyper
    return Hyper(*(torch.as_tensor(v, dtype=torch.float32).to(device)
                   for v in hp))


def _at(s: torch.Tensor, leaf: torch.Tensor, sweep: bool) -> torch.Tensor:
    """A Hyper value against one leaf: (S,) as (S, 1, ..., 1)."""
    if sweep and s.ndim:
        return s.reshape(s.shape + (1,) * (leaf.ndim - 1))
    return s


def prox_gap_sq(state: DepositumState, config: DepositumConfig,
                hyper: Optional[Hyper] = None,
                weights: Optional[torch.Tensor] = None, *,
                sweep: bool = False, axis=LOCAL_AXIS) -> torch.Tensor:
    """``(1/n) Σ_i ‖(x_i − prox_{αh}(x_i − α ν_i))/α‖²``, the in-loop
    gradient mapping along the momentum direction, leaf by leaf."""
    dev = next(iter(state.x.values())).device
    hp = _hp(config, hyper, dev)
    total = 0
    for k, p in state.x.items():
        a = _at(hp.alpha, p, sweep)
        shifted = p - a * state.nu[k]
        proxed = prox_apply(config.prox_name, {k: shifted}, a,
                            lam=_at(hp.lam, p, sweep),
                            theta=_at(hp.theta, p, sweep))[k]
        total = total + _weighted_sq((p - proxed) / a, weights, sweep, axis)
    return total / _n_clients(state, weights, sweep, axis)


def tracking_error(state: DepositumState, config: DepositumConfig,
                   hyper: Optional[Hyper] = None,
                   weights: Optional[torch.Tensor] = None, *,
                   sweep: bool = False, axis=LOCAL_AXIS) -> torch.Tensor:
    """``(1/n) Σ_i ‖y_i − β ḡ‖²`` with ḡ the client mean of ``state.g``,
    leaf by leaf."""
    dev = next(iter(state.x.values())).device
    hp = _hp(config, hyper, dev)
    total = 0
    for k, y in state.y.items():
        gbar = axis.client_mean(state.g[k], 1 if sweep else 0, weights)
        beta = _at(hp.beta, gbar, sweep).to(y.dtype)
        diff = y - (beta * gbar).unsqueeze(1 if sweep else 0)
        total = total + _weighted_sq(diff, weights, sweep, axis)
    return total / _n_clients(state, weights, sweep, axis)


def round_values(
    state: DepositumState,
    config: DepositumConfig,
    *,
    hyper: Optional[Hyper] = None,
    mixer: Any = None,
    aux: Any = None,
    active_mask: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
    d: Optional[int] = None,
    n: Optional[int] = None,
    staleness: Any = None,
    sweep: bool = False,
    axis=LOCAL_AXIS,
) -> dict:
    """All :data:`DEFAULT_METRICS` for the round that just finished.

    Call on the **post-round** state (``state.t`` already advanced); the
    round index is ``(t − 1) // T0``.  ``mixer`` (the round's schedule or
    plan) gives ``wire_bytes`` and, for cohort schedules, the eligibility
    ``weights`` and this round's ``active_mask`` when not given.  ``d`` is
    the flattened per-client parameter count (default: the state's).
    Reads only; never writes the state, so a run with metrics on is bit
    for bit the run with metrics off.  ``staleness`` None records 0.0.
    ``sweep=True`` takes ``(S, C, ...)`` leaves and (S,) Hyper values and
    gives (S,) values.  ``axis`` (a ``ShardAxis``): the state holds this
    process's rows of a sharded client axis, and every value reduces over
    the group (masks and ``weights`` are global).
    """
    first = next(iter(state.x.values()))
    dev = first.device
    lead = 2 if sweep else 1
    sched = getattr(mixer, "schedule", mixer)
    r = (state.t - 1) // config.comm_period
    if isinstance(sched, MixSchedule) and sched.kind == "cohort":
        if weights is None:
            weights = sched.sampler.eligible()
        if active_mask is None:
            active_mask = sched.sampler.mask_at(r)
    if d is None:
        d = sum(v[(0,) * lead].numel() for v in state.x.values())
    n_cl = _n_clients(state, weights, sweep, axis)
    if active_mask is not None:
        cohort = torch.sum(active_mask.to(torch.float32), dim=-1)
    else:
        cohort = _f32(n_cl, dev)
    if sweep and cohort.ndim == 0:
        cohort = cohort.expand(first.shape[0])
    if isinstance(sched, (MixSchedule, MixPlan)):
        wire = traced_round_bytes(sched, r, d, active_mask=active_mask, n=n,
                                  sweep=sweep, device=dev)
    else:
        wire = _f32(float("nan"), dev)
    loss = _loss_from_aux(aux, dev, sweep, axis)
    stale = _f32(0.0 if staleness is None else staleness, dev)
    if sweep:
        S = first.shape[0]
        wire, loss, stale = (v.to(dev).expand(S) if v.ndim == 0 else v
                             for v in (wire, loss, stale))
    return {
        "prox_grad_sq": prox_gap_sq(state, config, hyper, weights,
                                    sweep=sweep, axis=axis),
        "consensus_x": _consensus(state.x, weights, sweep, axis) / n_cl,
        "consensus_y": _consensus(state.y, weights, sweep, axis) / n_cl,
        "momentum_var": _consensus(state.nu, weights, sweep, axis) / n_cl,
        "track_err": tracking_error(state, config, hyper, weights,
                                    sweep=sweep, axis=axis),
        "cohort_size": cohort.to(torch.float32),
        "wire_bytes": wire.to(torch.float32),
        "loss": loss,
        "staleness": stale,
    }
