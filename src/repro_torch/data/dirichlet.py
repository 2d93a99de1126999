"""Dirichlet label-skew partitioner (paper Sec. V-A "Partitions", Fig. 2).

For class k over n clients, sample p_k ~ Dir(theta * 1_n) and give client i a
fraction p_ki of the class-k pool.  theta -> inf approaches IID; small theta
(e.g. 0.1) concentrates each class on few clients.
"""
from __future__ import annotations

import numpy as np


def dirichlet_partition(
    labels: np.ndarray,
    n_clients: int,
    theta: float,
    seed: int = 0,
    balance: bool = True,
) -> list[np.ndarray]:
    """Returns per-client index arrays covering all samples exactly once."""
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    classes = np.unique(labels)
    client_indices: list[list[int]] = [[] for _ in range(n_clients)]

    for k in classes:
        idx = np.flatnonzero(labels == k)
        rng.shuffle(idx)
        if np.isinf(theta):
            props = np.full(n_clients, 1.0 / n_clients)
        else:
            props = rng.dirichlet(np.full(n_clients, theta))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for i, part in enumerate(np.split(idx, cuts)):
            client_indices[i].extend(part.tolist())

    out = [np.asarray(sorted(ci), dtype=np.int64) for ci in client_indices]
    if balance:
        # equalise client set sizes (move extras round-robin) so batches stack
        target = len(labels) // n_clients
        pool: list[int] = []
        for i in range(n_clients):
            if len(out[i]) > target:
                pool.extend(out[i][target:].tolist())
                out[i] = out[i][:target]
        pi = 0
        for i in range(n_clients):
            need = target - len(out[i])
            if need > 0:
                out[i] = np.concatenate([out[i], np.asarray(pool[pi : pi + need])])
                pi += need
    return out


def label_proportions(partition: list[np.ndarray], labels: np.ndarray,
                      n_classes: int) -> np.ndarray:
    """(n_clients, n_classes) matrix of per-client class fractions (Fig. 2)."""
    n = len(partition)
    out = np.zeros((n, n_classes))
    for i, idx in enumerate(partition):
        if len(idx):
            binc = np.bincount(labels[idx], minlength=n_classes)
            out[i] = binc / max(binc.sum(), 1)
    return out
