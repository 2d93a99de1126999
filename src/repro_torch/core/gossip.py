"""Gossip mixing x <- (W ⊗ I) x over the client dim.

Port of ``repro/core/gossip.py``.  Client variables are dicts of tensors
whose leading dim is the client axis: all clients stacked (simulation),
or this process's block of a client axis sharded over a process group.

* :func:`make_dense_mixer` — contract the stacked states with the dense W
  (plus the dense mix of one leaf, alone or over a sweep axis).  A
  full-fp32 matrix product: TF32 must stay off (callers on the card set
  ``torch.backends.cuda.matmul.allow_tf32 = False``, the PyTorch default).
* :func:`make_neighbor_mixer` — sparse circulant W on a sharded client
  axis: one ``ppermute`` per neighbour offset (ring: 2, torus: 4).
* :func:`make_complete_mixer` — W = J: one ``pmean`` over the axis.

The collective mixers take a :class:`~repro_torch.launch.mesh.ShardAxis`
where the reference takes an ``axis_name``, one client per process; they
are :func:`repro_torch.core.mixing.shard_mixer` of the matching plan (the
distributed backend's mixer), imported when called because ``mixing``
imports this module.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device

Mixer = Callable[[dict], dict]


def identity_mixer(tree):
    return tree


def dense_mix_leaf(W: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``out_i = sum_j W_ij x_j`` on the leading dim of one leaf."""
    n = x.shape[0]
    return (W.to(x.dtype) @ x.reshape(n, -1)).reshape(x.shape)


def dense_mix_sweep_leaf(W: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``out_si = sum_j W_sij x_sj`` on one ``(S, n, ...)`` leaf: one
    batched full-fp32 product for all S points; ``W`` is ``(S, n, n)``
    per point or ``(n, n)`` shared."""
    S, n = x.shape[:2]
    return torch.matmul(W.to(x.dtype), x.reshape(S, n, -1)).reshape(x.shape)


def make_dense_mixer(W, *, device="cuda") -> Mixer:
    """x_i <- sum_j W_ij x_j on the leading client dim of every leaf.

    ``W`` (numpy or tensor, ``(n, n)``) is moved to ``device`` once, here,
    so the round loop does no host-to-device copy.
    """
    Wt = torch.as_tensor(W if isinstance(W, torch.Tensor) else np.asarray(W))
    Wt = Wt.to(resolve_device(device), torch.float32)

    def mix(tree):
        return {k: dense_mix_leaf(Wt, v) for k, v in tree.items()}

    return mix


def make_complete_mixer(axis) -> Mixer:
    """W = J over a sharded client axis: one all-reduce mean a leaf
    (``shard_mixer`` of the complete plan)."""
    from repro_torch.core.mixing import MixPlan, shard_mixer

    return shard_mixer(MixPlan.complete(), axis)


def make_neighbor_mixer(axis, offsets_weights: Sequence[tuple[int, float]],
                        self_weight: float, n: int, *,
                        device="cuda") -> Mixer:
    """Sparse circulant gossip over a sharded client axis via ``ppermute``
    (``shard_mixer`` of the circulant plan, its weights on ``device``).

    ``offsets_weights``: [(offset, weight)] — each client receives
    neighbour ``(i + offset) mod n`` with that weight (circulant W rows).
    For a Metropolis ring of n >= 3: offsets (+1, 1/3), (-1, 1/3), self
    1/3.  ``n`` is the axis size: one client a process.
    """
    from repro_torch.core.mixing import MixPlan, shard_mixer

    if n != axis.size:
        raise ValueError(f"a neighbour mixer of {n} clients needs an axis "
                         f"of {n} processes, got {axis.size}")
    plan = MixPlan.circulant(offsets_weights, self_weight, device=device)
    return shard_mixer(plan, axis)


def ring_mixer(axis, n: int, *, device="cuda") -> Mixer:
    """Metropolis ring weights as a neighbour mixer (n >= 3)."""
    if n < 3:
        return make_complete_mixer(axis)
    return make_neighbor_mixer(axis, [(+1, 1.0 / 3), (-1, 1.0 / 3)],
                               1.0 / 3, n, device=device)


def torus_grid_shape(n: int) -> tuple[int, int]:
    """The near-square a x b factorisation shared by ``torus_graph`` and
    :func:`torus_mixer`."""
    a = int(np.floor(np.sqrt(n)))
    while n % a != 0:
        a -= 1
    return a, n // a


def torus_circulant_spec(n: int):
    """(offsets_weights, self_weight) of the *circulant* torus on n clients.

    Not the same matrix as ``topology.torus_graph(n)``: the grid torus has
    neighbour (r, (c+1) mod b), which is client i+1 only when the column
    does not wrap, whereas a circulant shifts by a fixed offset — it
    connects i to (i±1) mod n and (i±b) mod n.  Both are symmetric doubly
    stochastic degree-4 graphs; the circulant is the form that maps onto
    ``ppermute``, so equivalence checks compare the neighbour mixer with
    :func:`circulant_from_mixer_spec` of this spec, never with
    ``torus_graph``.  On n = 2b the ±b offsets coincide and the shared edge
    absorbs both weights.  Returns the ring spec when the factorisation
    degenerates (a < 2), and ``(None, None)`` below 3 clients.
    """
    a, b = torus_grid_shape(n)
    if a < 2:
        if n < 3:
            return None, None  # degenerate: use complete
        return [(+1, 1.0 / 3), (-1, 1.0 / 3)], 1.0 / 3
    return [(+1, 0.2), (-1, 0.2), (+b, 0.2), (-b, 0.2)], 0.2


def torus_mixer(axis, n: int, *, device="cuda") -> Mixer:
    """Circulant-torus gossip: 4 ppermutes at offsets ±1, ±b (b = n // a),
    exactly the dense W of :func:`torus_circulant_spec`."""
    offsets_weights, self_weight = torus_circulant_spec(n)
    if offsets_weights is None:
        return make_complete_mixer(axis)
    return make_neighbor_mixer(axis, offsets_weights, self_weight, n,
                               device=device)


def circulant_from_mixer_spec(
    n: int, offsets_weights: Sequence[tuple[int, float]], self_weight: float
) -> np.ndarray:
    """Dense W equal to a neighbour mixer — to cross-check the two paths."""
    W = np.zeros((n, n))
    for i in range(n):
        W[i, i] += self_weight
        for off, w in offsets_weights:
            W[i, (i + off) % n] += w
    return W
