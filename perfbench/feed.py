"""The general generator of training traffic: per-client token streams
read from a traffic file's parameters and the run's seed.

Each client draws its tokens i.i.d. from a Zipf law over the model's
published vocabulary (``zipf_a``), through a permutation of the vocabulary
of its own (``client_permutation``): the clients' data differ, as a
federation's do.  The tokens of (client, step) come from a generator
seeded by (seed, client, step), so every run with one seed sees the same
tokens, steps and clients all differ, and any step can be made again.  A
round is a (T0, clients, B, L + 1) block: inputs are its first L tokens,
labels its last L.
"""
from __future__ import annotations

import numpy as np
import torch


class TokenFeed:
    def __init__(self, traffic: dict, vocab: int, seed: int):
        spec = traffic["tokens"]
        if spec["law"] != "zipf":
            raise ValueError(f"token law {spec['law']!r}: zipf")
        self.seed = int(seed)
        self.clients, self.batch = traffic["clients"], traffic["batch"]
        self.seq_len, self.t0 = traffic["seq_len"], traffic["t0"]
        rng = np.random.default_rng([self.seed, 0x7A1F])
        p = np.arange(1, vocab + 1, dtype=np.float64) ** (-spec["zipf_a"])
        self._cdf = np.cumsum(p / p.sum())
        self._cdf[-1] = 1.0
        self._perm = [rng.permutation(vocab) if spec["client_permutation"]
                      else np.arange(vocab) for _ in range(self.clients)]

    def step_tokens(self, step: int) -> np.ndarray:
        """(clients, B, L + 1) int32 tokens of DEPOSITUM step ``step``
        (0-based)."""
        out = np.empty((self.clients, self.batch, self.seq_len + 1), np.int32)
        for c in range(self.clients):
            rng = np.random.default_rng([self.seed, c, step])
            u = rng.random((self.batch, self.seq_len + 1))
            out[c] = self._perm[c][np.searchsorted(self._cdf, u, side="right")]
        return out

    def round_block(self, r: int) -> np.ndarray:
        """(T0, clients, B, L + 1) tokens of round ``r`` (0-based)."""
        return np.stack([self.step_tokens(r * self.t0 + i)
                         for i in range(self.t0)])

    def rounds(self, device, start: int = 0):
        """Yields each round's {"tokens", "labels"} on ``device``, leaves
        (T0, clients, B, L), from round ``start`` on."""
        r = start
        while True:
            block = torch.from_numpy(self.round_block(r)).to(device)
            r += 1
            yield {"tokens": block[..., :-1].contiguous(),
                   "labels": block[..., 1:].contiguous()}
