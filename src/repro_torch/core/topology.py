"""Communication topologies and doubly-stochastic mixing matrices.

Assumption 2 of the paper: W symmetric, doubly stochastic, supported on the
graph edges, with spectral quantity lambda = ||W - J|| in [0, 1).

We build Metropolis-Hastings weights, which satisfy Assumption 2 for any
connected undirected graph:
    w_ij = 1 / (1 + max(deg_i, deg_j))   (i,j) edge
    w_ii = 1 - sum_j w_ij
"""
from __future__ import annotations

import numpy as np


def _metropolis(adj: np.ndarray) -> np.ndarray:
    n = adj.shape[0]
    deg = adj.sum(axis=1)
    W = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if i != j and adj[i, j]:
                W[i, j] = 1.0 / (1.0 + max(deg[i], deg[j]))
        W[i, i] = 1.0 - W[i].sum()
    return W


def complete_graph(n: int) -> np.ndarray:
    """Fully connected: W = J, lambda = 0."""
    return np.full((n, n), 1.0 / n)


def ring_graph(n: int) -> np.ndarray:
    adj = np.zeros((n, n), dtype=bool)
    if n == 1:
        return np.ones((1, 1))
    for i in range(n):
        adj[i, (i + 1) % n] = adj[(i + 1) % n, i] = True
    if n == 2:
        # ring degenerates to a single edge
        return np.array([[0.5, 0.5], [0.5, 0.5]])
    return _metropolis(adj)


def star_graph(n: int) -> np.ndarray:
    """Client 0 is the hub (server-like); Metropolis keeps it symmetric."""
    adj = np.zeros((n, n), dtype=bool)
    for i in range(1, n):
        adj[0, i] = adj[i, 0] = True
    if n == 1:
        return np.ones((1, 1))
    return _metropolis(adj)


def torus_graph(n: int) -> np.ndarray:
    """2-D torus on a near-square grid (requires n = a*b, a,b >= 2 if possible)."""
    a = int(np.floor(np.sqrt(n)))
    while n % a != 0:
        a -= 1
    b = n // a
    adj = np.zeros((n, n), dtype=bool)
    if a == 1:
        return ring_graph(n)
    for r in range(a):
        for c in range(b):
            i = r * b + c
            for j in ((r * b + (c + 1) % b), (((r + 1) % a) * b + c)):
                if i != j:
                    adj[i, j] = adj[j, i] = True
    return _metropolis(adj)


def erdos_renyi_graph(n: int, p: float = 0.5, seed: int = 0) -> np.ndarray:
    """G(n, p) edges on top of a ring backbone.

    The backbone guarantees connectivity deterministically, so no
    sample-until-connected retry is needed; the result is validated against
    Assumption 2 before returning.
    """
    rng = np.random.default_rng(seed)
    adj = rng.random((n, n)) < p
    adj = np.triu(adj, 1)
    adj = adj | adj.T
    # ensure connectivity via a ring backbone
    for i in range(n):
        adj[i, (i + 1) % n] = adj[(i + 1) % n, i] = True
    np.fill_diagonal(adj, False)
    W = _metropolis(adj)
    validate_mixing(W)
    return W


TOPOLOGIES = {
    "complete": complete_graph,
    "ring": ring_graph,
    "star": star_graph,
    "torus": torus_graph,
    "erdos": erdos_renyi_graph,
}


def mixing_matrix(topology: str, n: int, **kwargs) -> np.ndarray:
    if topology not in TOPOLOGIES:
        raise KeyError(f"unknown topology {topology!r}; have {sorted(TOPOLOGIES)}")
    return TOPOLOGIES[topology](n, **kwargs)


def spectral_lambda(W: np.ndarray) -> float:
    """lambda = ||W - (1/n) 1 1^T||_2 = max(|lambda_2|, |lambda_n|)."""
    n = W.shape[0]
    J = np.full((n, n), 1.0 / n)
    return float(np.linalg.norm(W - J, ord=2))


def validate_mixing(W: np.ndarray, atol: float = 1e-10, *,
                    allow_negative: bool = False,
                    connected: bool = True) -> None:
    """Assert Assumption 2 holds.

    ``allow_negative=True`` relaxes the nonnegativity check (Chebyshev
    polynomials P_k(W) legitimately carry negative entries).
    ``connected=False`` skips the lambda < 1 contraction check — a lazy
    (Remark 3) per-round matrix may be non-contracting on its own (in the
    extreme, W^t = I when nobody participates); only the *expected* matrix
    must contract.
    """
    n = W.shape[0]
    if not np.allclose(W, W.T, atol=atol):
        raise ValueError("W not symmetric")
    if not np.allclose(W.sum(axis=1), 1.0, atol=atol):
        raise ValueError("W rows do not sum to 1")
    if not allow_negative and np.any(W < -atol):
        raise ValueError("W has negative entries")
    if connected:
        lam = spectral_lambda(W)
        if n > 1 and not lam < 1.0:
            raise ValueError(f"graph appears disconnected: lambda={lam}")


def chebyshev_matrix(W: np.ndarray, k: int) -> np.ndarray:
    """Chebyshev-accelerated mixing: P_k(W) = T_k(W/lam) / T_k(1/lam).

    The paper notes (Sec. I-A) that multi-exchange methods "can be improved
    by introducing the Chebyshev mixing protocol" — this is that protocol as
    a drop-in mixing matrix: k neighbor exchanges per round with the optimal
    polynomial weights, shrinking the effective spectral radius far faster
    than W^k.  P_k(W) keeps symmetry and rows summing to one (so the
    tracking identity survives) but may have negative entries — a known,
    benign departure from Assumption 2's nonnegativity (cf. Scaman et al.
    2017, optimal decentralized algorithms).

    ``k < 1`` and non-symmetric ``W`` are rejected: the T_k recurrence is
    only the optimal polynomial for symmetric W, and a k = 0 "plan" is not
    a communication round at all.
    """
    W = np.asarray(W)
    if k < 1:
        raise ValueError(f"chebyshev_matrix needs k >= 1, got k={k}")
    if W.ndim != 2 or W.shape[0] != W.shape[1]:
        raise ValueError(f"chebyshev_matrix needs a square W, got {W.shape}")
    if not np.allclose(W, W.T, atol=1e-8):
        raise ValueError("chebyshev_matrix needs a symmetric W "
                         "(Assumption 2); got a non-symmetric matrix")
    n = W.shape[0]
    lam = spectral_lambda(W)
    if lam < 1e-12 or k == 1:
        # P_1(W) = W exactly; lam -> 0 is the complete-graph limit where
        # acceleration has nothing left to accelerate
        return W.copy()
    inv = 1.0 / lam
    # T_k recurrence evaluated at W/lam (matrix) and at 1/lam (scalar)
    Tm2, Tm1 = np.eye(n), W * inv
    tm2, tm1 = 1.0, inv
    for _ in range(k - 1):
        Tm2, Tm1 = Tm1, 2.0 * inv * (W @ Tm1) - Tm2
        tm2, tm1 = tm1, 2.0 * inv * tm1 - tm2
    return Tm1 / tm1


def lazy_subgraph_matrix(W: np.ndarray, active: np.ndarray) -> np.ndarray:
    """Time-varying network (paper Remark 3): only edges whose BOTH endpoints
    are in ``active`` communicate this round; inactive mass folds into the
    diagonal, keeping the matrix symmetric doubly stochastic."""
    n = W.shape[0]
    Wt = np.zeros_like(W)
    for i in range(n):
        for j in range(n):
            if i != j and active[i] and active[j]:
                Wt[i, j] = W[i, j]
        Wt[i, i] = 1.0 - Wt[i].sum()
    return Wt


def delta_coefficients(lam: float, alpha_rho: float, T0: int) -> tuple[float, float]:
    """The paper's delta_1, delta_2 constants (used by the beta bound)."""
    if lam == 0.0:
        d1 = (T0 ** T0) * (1 - alpha_rho) ** (2 * T0 + 2) / ((1 + T0) ** (T0 + 1))
        d2 = (T0 ** T0) / float((1 + T0) ** (T0 + 1))
    else:
        d1 = lam * (1 - lam) * ((1 - alpha_rho) ** 2 - lam ** (1.0 / T0))
        d2 = lam * (1 - lam) * (1 - lam ** (1.0 / T0))
    return d1, d2
