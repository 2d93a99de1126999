"""Deterministic synthetic classification data (numpy; offline).

Port of the classification half of ``repro/data/synthetic.py``: an
A9A/MNIST-like labelled set generated from a sparse teacher, partitioned
across clients by Dirichlet label skew.  The arrays equal the reference's
exactly for the same arguments.  The token stream of the federated LM
runs (:class:`SyntheticTokenStream`, per-client Zipf unigrams under a
client-specific vocabulary permutation) is numpy too, so its tokens equal
the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.dirichlet import dirichlet_partition


@dataclasses.dataclass
class SyntheticClassification:
    """x: (N, d) float32; y: (N,) int labels; per-client index partition."""

    x: np.ndarray
    y: np.ndarray
    partition: list[np.ndarray]
    n_classes: int

    def client_arrays(self, i: int):
        idx = self.partition[i]
        return self.x[idx], self.y[idx]

    def stacked_batches(self, rng: np.random.Generator, batch: int, steps: int):
        """(steps, n_clients, batch, ...) arrays for one round."""
        n = len(self.partition)
        xs = np.empty((steps, n, batch) + self.x.shape[1:], np.float32)
        ys = np.empty((steps, n, batch), np.int32)
        for i in range(n):
            idx = self.partition[i]
            pick = rng.choice(idx, size=(steps, batch), replace=True)
            xs[:, i] = self.x[pick]
            ys[:, i] = self.y[pick]
        return xs, ys


def make_classification(
    n_samples: int = 4096,
    n_features: int = 64,
    n_classes: int = 10,
    n_clients: int = 10,
    theta: float = 1.0,
    seed: int = 0,
    teacher_sparsity: float = 0.5,
    label_noise: float = 0.05,
) -> SyntheticClassification:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_samples, n_features)).astype(np.float32)
    teacher = rng.standard_normal((n_features, n_classes))
    mask = rng.random((n_features, 1)) > teacher_sparsity
    teacher = teacher * mask                       # sparse ground truth: l1 apt
    logits = x @ teacher + 0.5 * np.tanh(x[:, :n_classes])  # mild nonlinearity
    y = np.argmax(logits, axis=1)
    flip = rng.random(n_samples) < label_noise
    y[flip] = rng.integers(0, n_classes, flip.sum())
    part = dirichlet_partition(y, n_clients, theta, seed=seed + 1)
    return SyntheticClassification(x=x, y=y.astype(np.int32), partition=part,
                                   n_classes=n_classes)


@dataclasses.dataclass
class SyntheticTokenStream:
    """Deterministic per-client token sampler with heterogeneous statistics."""

    vocab_size: int
    n_clients: int
    seed: int = 0
    zipf_a: float = 1.2

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        ranks = np.arange(1, self.vocab_size + 1, dtype=np.float64)
        base = ranks ** (-self.zipf_a)
        # client-specific vocabulary permutation => heterogeneous unigrams
        self._perms = [
            rng.permutation(self.vocab_size) for _ in range(self.n_clients)
        ]
        self._probs = base / base.sum()

    def batch(self, client: int, step: int, batch: int, seq_len: int) -> np.ndarray:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + client) * 1_000_003 + step
        )
        raw = rng.choice(self.vocab_size, size=(batch, seq_len + 1), p=self._probs)
        return self._perms[client][raw].astype(np.int32)

    def stacked_round(self, step0: int, t0: int, batch: int, seq_len: int):
        """(T0, n_clients, batch, seq+1) token block for one round."""
        out = np.empty((t0, self.n_clients, batch, seq_len + 1), np.int32)
        for t in range(t0):
            for c in range(self.n_clients):
                out[t, c] = self.batch(c, step0 + t, batch, seq_len)
        return out


def make_federated_lm_streams(vocab_size: int, n_clients: int, seed: int = 0):
    return SyntheticTokenStream(vocab_size=vocab_size, n_clients=n_clients,
                                seed=seed)
