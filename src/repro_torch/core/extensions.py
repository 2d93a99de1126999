"""Beyond-paper extensions the paper's conclusion points at (port of
``repro/core/extensions.py``):

* **Byzantine-resilient gossip** ("we aim to integrate ...
  Byzantine-resilient variants", Sec. VI): coordinate-wise trimmed-mean
  aggregation over each client's neighbourhood.  Robust to up to ``trim``
  arbitrary neighbours per client, at the cost of the doubly-stochastic
  property (the tracking identity holds only approximately under attack).
* **Compressed gossip** (CHOCO-gossip, Koloskova et al. 2019): exchange
  top-k sparsified *increments* against shared public copies x̂.

  **Deprecated**: compression is a first-class operand —
  :class:`repro_torch.core.compression.CompressionSpec` attaches to any
  :class:`~repro_torch.core.schedule.MixSchedule`
  (``schedule.with_compression(spec)``) and sweeps over rates as one run.
  The functions below stay as thin shims over those primitives, in the
  legacy order (compress, update x̂, then a *fresh* dense mix of the
  public copies), so old trajectories reproduce.

The shims and the mixer take a bare ``(n, ...)`` tensor or a dict of them.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.compression import _topk_rows
from repro_torch.core.mixing import MixPlan, apply_mix

#: what pushes non-neighbours past every real value in the sort (the
#: reference's float32 constant)
_BIG = 3.4e38


# ---------------------------------------------------------------------------
# Byzantine-resilient trimmed-mean gossip
# ---------------------------------------------------------------------------

def make_trimmed_mean_mixer(W: np.ndarray, trim: int = 1):
    """Coordinate-wise trimmed mean over each client's closed neighbourhood.

    For client i: gather {x_j : w_ij > 0} (itself included), drop the
    ``trim`` largest and smallest values per coordinate, average the rest.
    Requires every neighbourhood to have > 2*trim members.  Each leaf is
    one batched sort over ``(client, neighbour, coordinate)``.
    """
    adj = np.asarray(W) > 0
    np.fill_diagonal(adj, True)
    counts = adj.sum(1)
    if (counts <= 2 * trim).any():
        raise ValueError(f"trim={trim} too large for degree "
                         f"{int(counts.min()) - 1} neighborhoods")
    adj_t = torch.from_numpy(adj)
    placed: dict = {}

    def leaf(x: torch.Tensor) -> torch.Tensor:
        if x.device not in placed:
            placed[x.device] = adj_t.to(x.device)
        mask = placed[x.device]                              # (n, n)
        n = x.shape[0]
        flat = x.reshape(n, -1).to(torch.float32)
        # row i: neighbours of client i first (sorted), then +big padding
        vals = torch.where(mask[:, :, None], flat[None],
                           torch.tensor(_BIG, device=x.device))
        asc = torch.sort(vals, dim=1).values                  # (n, n, d)
        k = mask.sum(1)                                       # (n,)
        lo, hi = trim, k - trim                               # keep [lo, hi)
        idx = torch.arange(n, device=x.device)[None, :]
        keep = (idx >= lo) & (idx < hi[:, None])              # (n, n)
        s = torch.where(keep[:, :, None], asc, 0.0).sum(1) / torch.clamp_min(
            hi - lo, 1)[:, None].to(torch.float32)
        return s.reshape(x.shape).to(x.dtype)

    def mix(tree):
        if isinstance(tree, dict):
            return {k: leaf(v) for k, v in tree.items()}
        return leaf(tree)

    return mix


# ---------------------------------------------------------------------------
# Compressed gossip with error feedback (CHOCO-style)
# ---------------------------------------------------------------------------

def topk_compress(x: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest-magnitude coordinates per client row; zero rest.

    Deprecated shim over the row compressor behind
    ``CompressionSpec.topk`` (the same threshold semantics: ties at the
    k-th magnitude all survive).
    """
    n = x.shape[0]
    flat = x.reshape(n, -1)
    d = flat.shape[1]
    k = min(int(k), d)
    rate = torch.tensor(k / d, dtype=torch.float32, device=x.device)
    return _topk_rows(flat, rate).reshape(x.shape)


class CompressedGossipState(NamedTuple):
    xhat: torch.Tensor    # (n, ...) public copies every client agrees on


def init_compressed(x: torch.Tensor) -> CompressedGossipState:
    return CompressedGossipState(xhat=torch.zeros_like(x))


def compressed_gossip_round(x: torch.Tensor, st: CompressedGossipState,
                            W: np.ndarray, k: int, step: float = 0.3):
    """One CHOCO-gossip round on the stacked states.

    Clients broadcast ``q_i = C_k(x_i - xhat_i)`` and everyone updates the
    shared copies ``xhat += q`` (the x̂ table is the compression memory:
    the untransmitted residual is retried next round).  States then take a
    damped gossip step on the public copies: ``x <- x + step (W - I)
    xhat``.  Returns ``(new_x, new_state, k / d)``, the last the traffic
    relative to dense gossip.

    Deprecated shim: recomposed from ``repro_torch.core.compression`` in
    the legacy order (compress, x̂ update, fresh dense mix); new code
    attaches a spec to its schedule and lets ``depositum.step`` run the
    exchange.
    """
    q = topk_compress(x - st.xhat, k)
    xhat = st.xhat + q
    plan = MixPlan.dense(np.asarray(W, np.float32), device=x.device)
    mixed = apply_mix(plan, {"x": xhat})["x"]
    x_new = x + step * (mixed - xhat)
    d = x[0].numel()
    return x_new, CompressedGossipState(xhat=xhat), k / d
