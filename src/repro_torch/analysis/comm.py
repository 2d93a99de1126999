"""Bytes-on-wire accounting for (compressed) gossip rounds.

Port of ``repro/analysis/comm.py``: what a DEPOSITUM comm round puts on the
network under any :class:`~repro_torch.core.schedule.MixSchedule` and any
:class:`~repro_torch.core.compression.CompressionSpec`, per directed edge,
per client row, per round.  It prices the accuracy-vs-bytes frontier
(``repro_torch.figures``, ``--fig comm``).

The model is algorithmic bytes: one row payload per transmitting directed
edge of the round's effective graph.  Counting rules, per schedule kind:

* constant / stacked / alternating — every nonzero off-diagonal edge of
  the round's W transmits once.
* chebyshev — each round runs ``cheby_k`` collectives over the base graph.
* lazy / cohort — only edges with both endpoints active transmit; with a
  round index the drawn mask is counted exactly, otherwise the expectation
  over the sampler (Bernoulli: p^2 per edge; fixed-size k: k(k-1)/(n(n-1));
  pre-drawn masks: their mean activity squared).

Per-row payload: dense f32 rows (no spec / ``none``); value + index pairs
for the sparse kinds (``wire_k`` slots when packed, else ``round(rate *
d)``); int8 words + one f32 norm for qsgd.  Everything here is numpy on
host copies of the operands' tensors (which may live on the card), and
vectorises over sweep-stacked specs, returning ``(S,)`` arrays.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.compression import KIND_IDS, CompressionSpec
from repro_torch.core.mixing import MixPlan, as_dense
from repro_torch.core.schedule import MixSchedule, as_schedule

#: f32 values / int32 indices on the wire.
VALUE_BYTES = 4
INDEX_BYTES = 4
#: qsgd ships one signed level word per coordinate + one norm per row.
QSGD_WORD_BYTES = 1
QSGD_NORM_BYTES = 4


def _np(v) -> np.ndarray:
    """A host numpy copy of a tensor (or an array-like)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def payload_row_bytes(spec: Optional[CompressionSpec], d: int) -> np.ndarray:
    """Bytes one client row of one mixed variable ships per collective:
    a scalar array for an unstacked spec, ``(S,)`` for a stacked one."""
    d = int(d)
    dense = np.asarray(float(d * VALUE_BYTES))
    if spec is None or spec.kind == "none":
        return dense

    def sparse_bytes():
        if spec.wire_k > 0:
            k = np.minimum(spec.wire_k, d)
            return np.asarray(float(k * (VALUE_BYTES + INDEX_BYTES)))
        rate = _np(spec.rate).astype(np.float64)
        k = np.clip(np.round(rate * d), 1, d)
        return k * (VALUE_BYTES + INDEX_BYTES)

    quant = np.asarray(float(d * QSGD_WORD_BYTES + QSGD_NORM_BYTES))
    if spec.kind in ("topk", "randk"):
        return np.broadcast_to(sparse_bytes(),
                               np.shape(_np(spec.rate))).copy()
    if spec.kind == "qsgd":
        return np.broadcast_to(quant, np.shape(_np(spec.bits))).copy()
    # mixed: elementwise dispatch on the kind_id values
    kid = _np(spec.kind_id)
    table = np.stack(np.broadcast_arrays(
        dense, sparse_bytes(), sparse_bytes(), quant))
    return np.choose(np.minimum(kid, len(KIND_IDS) - 1), table)


def collectives_per_round(sched: MixSchedule | MixPlan) -> int:
    """How many collectives one comm round runs (chebyshev: its k)."""
    sched = as_schedule(sched)
    return max(1, sched.plan.cheby_k) if sched.plan.kind == "chebyshev" \
        else 1


def _dense_edges(W, atol: float = 1e-12) -> float:
    """Directed transmitting edges of a concrete W: nonzero off-diagonal."""
    W = _np(W)
    off = W - np.diag(np.diag(W))
    return float(np.count_nonzero(np.abs(off) > atol))


def _base_edges(plan: MixPlan, n: int | None) -> float:
    """Directed edges of the plan's per-collective base graph."""
    if plan.kind == "chebyshev":
        plan = plan.base_plan()
    if plan.kind == "identity":
        return 0.0
    if plan.kind == "circulant":
        if n is None:
            raise ValueError("edge count over a circulant plan needs n")
        return float(n * len(plan.offsets))
    if plan.kind == "complete":
        if n is None:
            raise ValueError("edge count over a complete plan needs n")
        return float(n * (n - 1))
    return _dense_edges(plan.W)


def _mask_edge_fraction(plan: MixPlan, a: np.ndarray) -> float:
    """Share of the plan's off-diagonal edges with both endpoints active."""
    W = _np(as_dense(plan, a.shape[-1], device="cpu").W)
    off = np.abs(W - np.diag(np.diag(W))) > 1e-12
    total = max(np.count_nonzero(off), 1)
    return float(np.count_nonzero(off * np.outer(a > 0.5, a > 0.5))) / total


def _active_edge_fraction(sched: MixSchedule, r: int | None) -> float:
    """Fraction of base edges transmitting in a lazy/cohort round."""
    if sched.active is not None:
        a = _np(sched.active)
        if r is not None:
            return _mask_edge_fraction(sched.plan,
                                       a[min(int(r), a.shape[0] - 1)])
        p = float(np.mean(a))
        return p * p
    sampler = sched.sampler
    n_eff = float(_np(sampler.n_eff))
    if r is not None:
        return _mask_edge_fraction(sched.plan, _np(sampler.mask_at(int(r))))
    if sampler.kind == "bernoulli":
        p = float(_np(sampler.p_active))
        return p * p
    if sampler.kind == "fixed":
        k = min(float(_np(sampler.k)), n_eff)
        return (k * max(k - 1, 0.0)) / max(n_eff * (n_eff - 1), 1.0)
    return 1.0  # full participation


def round_edges(sched: MixSchedule | MixPlan, n: int | None = None,
                r: int | None = None) -> float:
    """Transmitting directed edges of one comm round (one collective).

    ``r=None`` returns the expectation for randomised kinds and the round-0
    graph for ``stacked`` / ``alternating`` (pass ``r`` for exact per-round
    counts).  Unswept operands only (see :func:`sweep_round_bytes`).
    """
    sched = as_schedule(sched)
    if sched.is_stacked:
        raise ValueError("round_edges takes one sweep point "
                         "(sched.point(s)); see sweep_round_bytes")
    if sched.kind in ("stacked", "alternating"):
        return _dense_edges(as_dense(sched.plan_at(r or 0), n,
                                     device="cpu").W)
    base = _base_edges(sched.plan, n)
    if sched.kind in ("lazy", "cohort"):
        return base * _active_edge_fraction(sched, r)
    return base


def round_wire_bytes(sched: MixSchedule | MixPlan, d: int,
                     n: int | None = None, r: int | None = None,
                     n_vars: int = 2) -> np.ndarray:
    """Total bytes on the wire for one comm round of the whole graph.

    ``d`` is the flattened per-client parameter dimension; ``n_vars`` the
    number of variables a comm step mixes (DEPOSITUM gossips x and the
    tracking variable y: 2).  Chebyshev rounds multiply by their k
    collectives.  Vectorises over a stacked spec on an unswept schedule.
    """
    sched = as_schedule(sched)
    edges = round_edges(sched, n, r)
    per_row = payload_row_bytes(sched.compress, d)
    return edges * per_row * collectives_per_round(sched) * n_vars


def sweep_round_bytes(sched: MixSchedule, d: int, n: int | None = None,
                      r: int | None = None, n_vars: int = 2) -> np.ndarray:
    """(S,) bytes a round per sweep point of a stacked schedule."""
    if not sched.is_stacked:
        return np.atleast_1d(round_wire_bytes(sched, d, n, r, n_vars))
    return np.asarray([
        float(round_wire_bytes(sched.point(s), d, n, r, n_vars))
        for s in range(sched.n_sweep)])


def device_wire_bytes(sched: MixSchedule | MixPlan, d: int, n_clients: int,
                      n_devices: int, n_vars: int = 2) -> float:
    """Bytes one device sends per comm round on a sharded client axis: it
    holds ``n_clients / n_devices`` rows, and every collective ships each
    row's payload once per neighbour exchange (circulant: per offset) or
    once into the all_gather (dense / complete)."""
    sched = as_schedule(sched)
    if sched.is_stacked:
        raise ValueError("device_wire_bytes takes one sweep point")
    blk = max(int(n_clients) // max(int(n_devices), 1), 1)
    plan = sched.plan
    base = plan.base_plan() if plan.kind == "chebyshev" else plan
    fanout = len(base.offsets) if base.kind == "circulant" else 1
    per_row = float(np.max(payload_row_bytes(sched.compress, d)))
    return blk * per_row * fanout * collectives_per_round(sched) * n_vars


def spec_bits_per_coord(spec: Optional[CompressionSpec],
                        d: int) -> np.ndarray:
    """Wire bits per coordinate, the x-axis of the accuracy-vs-bytes
    frontier (dense f32 = 32)."""
    return payload_row_bytes(spec, d) * 8.0 / float(d)
