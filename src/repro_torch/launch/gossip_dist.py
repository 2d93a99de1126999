"""Topology-aware distributed gossip: mix plans under a placement (port of
``repro/launch/gossip_dist.py``).

The paper-faithful mix contracts the stacked client states with the dense
W: an all_gather over the client axis (O(n |theta|) bytes a device) and a
local product.  A sparse topology (ring: 2 neighbours) needs only O(deg
|theta| / n): one ``ppermute`` per neighbour offset.

The mixers are :func:`repro_torch.core.mixing.shard_mixer` and
:func:`repro_torch.core.schedule.shard_schedule_mixer` (over the per-kind
bodies ``shard_body`` / ``shard_schedule_body``), the builders
:class:`~repro_torch.training.backends.ShardMapBackend` calls too, so the
launch path and the sweep path cannot drift apart.  This module adds what
is placement-specific: each leaf's client dim is mapped
by the placement's :func:`~repro_torch.launch.sharding.spec_for`.  Where
it shards over the client axes, the leaf holds this process's block and
mixes through the axis's collectives; where the rules replicate it
(indivisible counts), every process holds all clients and mixes them
locally.
"""
from __future__ import annotations

from typing import Any

from repro_torch.core.mixing import MixPlan, shard_mixer
from repro_torch.core.schedule import (
    MixSchedule,
    ScheduleMixer,
    shard_schedule_mixer,
)
from repro_torch.launch.sharding import Placement, spec_for


def plan_for_topology(topology: str, n: int, *, device="cuda") -> MixPlan:
    """The cheapest *exact* distributed plan for a named topology:
    ``MixPlan.from_topology(..., prefer="sparse")``."""
    return MixPlan.from_topology(topology, n, prefer="sparse", device=device)


def _sharded(placement: Placement, axes_tree: dict, shapes_tree: dict
             ) -> dict:
    """Leaf name -> whether its client dim (dim 0) is sharded over the
    placement's client axes."""
    caxes = placement.clients_axes
    want = caxes[0] if len(caxes) == 1 else tuple(caxes)
    out = {}
    for k, a in axes_tree.items():
        shape = tuple(getattr(shapes_tree[k], "shape", shapes_tree[k]))
        spec = spec_for(placement, tuple(a), shape)
        out[k] = bool(spec) and spec[0] == want
    return out


def _client_axis(placement: Placement):
    caxes = placement.clients_axes
    return placement.mesh.axis(caxes if len(caxes) > 1 else caxes[0])


def make_shardmap_mixer(placement: Placement, axes_tree: Any,
                        shapes_tree: Any, plan: MixPlan):
    """Mixer over the placement's client axes executing ``plan``.

    ``axes_tree`` / ``shapes_tree`` describe the *state* leaves (with the
    leading 'clients' logical dim; flat dicts by leaf name, global shapes).
    Dispatch per plan kind (pmean / ppermute / all_gather + rows of W) is
    :func:`~repro_torch.core.mixing.shard_body`.
    """
    if isinstance(plan, MixSchedule):
        return make_shardmap_schedule_mixer(placement, axes_tree,
                                            shapes_tree, plan)
    if placement.n_clients <= 1 or not placement.clients_axes:
        return lambda tree: tree
    return shard_mixer(plan, _client_axis(placement),
                       sharded=_sharded(placement, axes_tree, shapes_tree))


def make_shardmap_schedule_mixer(placement: Placement, axes_tree: Any,
                                 shapes_tree: Any, schedule: MixSchedule):
    """Round-indexed placement mixer ``mix(tree, r)``: the per-round
    dispatch of :func:`~repro_torch.core.schedule.shard_schedule_body`
    (masked collectives for lazy / cohort rounds, unrolled chebyshev
    collectives, the round's plan of a stacked schedule), and, where the
    schedule's compressed increments pack and every leaf is sharded,
    ``wire_fn`` (:func:`~repro_torch.core.schedule.shard_compressed_qmix`):
    :func:`~repro_torch.core.schedule.shard_schedule_mixer`, as the
    backend builds it."""
    n = placement.n_clients
    if n <= 1 or not placement.clients_axes:
        return ScheduleMixer(lambda tree, r: tree, schedule)
    sharded = _sharded(placement, axes_tree, shapes_tree)
    axis = _client_axis(placement)
    rows = axis.rows(n) if all(sharded.values()) else None
    return shard_schedule_mixer(schedule, axis, rows, sharded=sharded)


def make_shardmap_ring_mixer(placement: Placement, axes_tree: Any,
                             shapes_tree: Any, topology: str = "ring",
                             *, device="cuda"):
    """The ring / complete ppermute mixer by topology name."""
    if topology not in ("ring", "complete"):
        raise ValueError(f"shardmap mixer supports ring|complete, got "
                         f"{topology}")
    plan = plan_for_topology(topology, placement.n_clients, device=device)
    return make_shardmap_mixer(placement, axes_tree, shapes_tree, plan)
