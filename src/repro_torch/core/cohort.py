"""Per-round client cohorts: the :class:`CohortSampler` operand.

Port of ``repro/core/cohort.py``.  A sampler fixes two things at once:

* **a padded (ragged) client axis** — every state leaf carries ``n_max``
  client rows; only the first ``n_eff`` are *eligible*.  Padding rows ride
  along with zero weight: the cohort schedule's mix folds them out and the
  round program freezes them, so one run serves any ``n <= n_max`` and
  ``n_clients`` becomes a sweep dimension;
* **per-round client sampling** — each round an i.i.d.
  Bernoulli(``p_active``) or a uniform fixed-size ``k``-of-``n_eff``
  cohort, drawn on the samplers' device with no host copy.

The reference draws with JAX's threefry (``fold_in(fold_in(key, r), i)``),
which PyTorch cannot reproduce.  The port draws client ``i``'s uniform for
round ``r`` from a counter-based hash of ``(seed, r, i)`` (two rounds of a
32-bit integer mixer, computed in int64 tensor arithmetic on the device),
so the same three integers give the same bits on the CPU and on the card,
and client ``i``'s draw never depends on ``n_max``: a padded sampler
reproduces its unpadded twin on the shared prefix.  Parity tests with the
reference inject its masks instead.

``kind`` and ``n_max`` are structure; ``n_eff``, ``p_active``, ``k`` and
``seed`` are tensors that stack on a leading sweep axis
(:func:`stack_cohorts`), as :class:`~repro_torch.core.hyper.Hyper` and
:class:`~repro_torch.core.mixing.MixPlan` do.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.mixing import MixPlan, as_dense

_LEAVES = ("n_eff", "p_active", "k", "seed")
_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32) and a 32-bit
    constant ``c``, without leaving int64's range: x's high half meets only
    c's low half (the rest falls above bit 32)."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + ((hi * (c & 0xFFFF)) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer mixer (xor-shift / multiply, two rounds): a
    bijection of [0, 2**32) whose outputs look independent of its inputs.
    The xor-shift / multiply rounds alone map 0 to 0, which would pin the
    commonest input (seed 0, round 0, client 0) to the uniform 0.0, so the
    input is first xored with an odd constant (the golden ratio's bits)."""
    x = x ^ 0x9E3779B9
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def client_uniforms(seed: torch.Tensor, r: int, n: int) -> torch.Tensor:
    """One float32 uniform in [0, 1) per client for round ``r``: client
    ``i``'s is a function of ``(seed, r, i)`` alone.  ``seed`` is an int64
    tensor, () or (S,); returns ``(n,)`` or ``(S, n)`` on its device."""
    i = torch.arange(n, device=seed.device, dtype=torch.int64)
    key = _mix32(_mix32(seed[..., None] & _M32) ^ (int(r) & _M32))
    return (_mix32(key ^ i) >> 8).to(torch.float32) * 2.0 ** -24


@dataclasses.dataclass(frozen=True)
class CohortSampler:
    """Which clients participate each round.

    Build with the classmethod constructors; ``kind`` and ``n_max`` are
    structure, the tensors may carry a leading ``(S,)`` sweep axis after
    :func:`stack_cohorts`.
    """

    kind: str                              # full | bernoulli | fixed
    n_max: int                             # padded axis length
    n_eff: torch.Tensor = None             # () or (S,) int64, <= n_max
    p_active: Optional[torch.Tensor] = None  # bernoulli: () or (S,) f32
    k: Optional[torch.Tensor] = None       # fixed: () or (S,) int64
    seed: Optional[torch.Tensor] = None    # () or (S,) int64

    # -- constructors -------------------------------------------------------
    @classmethod
    def full(cls, n_eff: int, n_max: int | None = None, *,
             device="cuda") -> "CohortSampler":
        """Every eligible client participates every round (sampling off,
        padding on)."""
        n_max = int(n_max) if n_max is not None else int(n_eff)
        cls._check_sizes(n_eff, n_max)
        dev = resolve_device(device)
        return cls(kind="full", n_max=n_max, n_eff=_int(n_eff, dev))

    @classmethod
    def bernoulli(cls, p_active: float, n_max: int, *, seed: int = 0,
                  n_eff: int | None = None,
                  device="cuda") -> "CohortSampler":
        """Each eligible client participates i.i.d. with probability
        ``p_active`` (DFedAvg's ``act_prob``)."""
        p = np.asarray(p_active, np.float32)
        if not (0.0 <= float(p.min()) and float(p.max()) <= 1.0):
            raise ValueError(f"p_active must be in [0, 1], got {p_active}")
        n_eff = n_max if n_eff is None else n_eff
        cls._check_sizes(n_eff, n_max)
        dev = resolve_device(device)
        return cls(kind="bernoulli", n_max=int(n_max),
                   n_eff=_int(n_eff, dev),
                   p_active=torch.as_tensor(p, device=dev),
                   seed=_int(seed, dev))

    @classmethod
    def fixed_size(cls, k: int, n_max: int, *, seed: int = 0,
                   n_eff: int | None = None,
                   device="cuda") -> "CohortSampler":
        """A uniform ``k``-of-``n_eff`` cohort without replacement each
        round (FedProx's ``n_workers_per_round``); ``k >= n_eff`` clamps to
        full participation."""
        n_eff = n_max if n_eff is None else n_eff
        cls._check_sizes(n_eff, n_max)
        if int(np.min(k)) < 1:
            raise ValueError(f"fixed_size cohorts need k >= 1, got {k}")
        dev = resolve_device(device)
        return cls(kind="fixed", n_max=int(n_max), n_eff=_int(n_eff, dev),
                   k=_int(k, dev), seed=_int(seed, dev))

    @staticmethod
    def _check_sizes(n_eff, n_max) -> None:
        if int(n_max) < 1:
            raise ValueError(f"n_max must be >= 1, got {n_max}")
        if int(np.min(n_eff)) < 1 or int(np.max(n_eff)) > int(n_max):
            raise ValueError(
                f"n_eff must be in [1, n_max={n_max}], got {n_eff}")

    # -- introspection ------------------------------------------------------
    @property
    def is_stacked(self) -> bool:
        return self.n_eff.ndim == 1

    @property
    def n_sweep(self) -> int:
        return int(self.n_eff.shape[0]) if self.is_stacked else 1

    @property
    def device(self) -> torch.device:
        return self.n_eff.device

    def point(self, s: int) -> "CohortSampler":
        if not self.is_stacked:
            return self
        return dataclasses.replace(self, **{
            f: getattr(self, f)[s] for f in _LEAVES
            if getattr(self, f) is not None})

    def to(self, device) -> "CohortSampler":
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in _LEAVES
            if getattr(self, f) is not None})

    # -- the draws ----------------------------------------------------------
    def eligible(self) -> torch.Tensor:
        """(n_max,) — or (S, n_max) — 0/1 float32 padding mask: 1 on the
        first ``n_eff`` rows."""
        rows = torch.arange(self.n_max, device=self.device)
        return (rows < self.n_eff[..., None]).to(torch.float32)

    def mask_at(self, r: int) -> torch.Tensor:
        """(n_max,) — or (S, n_max) — 0/1 float32 active mask for round
        ``r``, drawn on the sampler's device, deterministic in (seed, r):
        the round program and the mixing path both call it and agree."""
        elig = self.eligible() > 0
        if self.kind == "full":
            return elig.to(torch.float32)
        u = client_uniforms(self.seed, r, self.n_max)
        if self.kind == "bernoulli":
            return (elig & (u < self.p_active[..., None])).to(torch.float32)
        # fixed: the k smallest uniforms among eligible clients (ties by
        # client index)
        u = torch.where(elig, u, torch.full_like(u, float("inf")))
        order = torch.argsort(u, dim=-1, stable=True)
        ranks = torch.argsort(order, dim=-1, stable=True)
        return (elig & (ranks < self.k[..., None])).to(torch.float32)

    def expected_active(self) -> torch.Tensor:
        """E[#active clients a round]."""
        ne = self.n_eff.to(torch.float32)
        if self.kind == "full":
            return ne
        if self.kind == "bernoulli":
            return ne * self.p_active
        return torch.minimum(self.k.to(torch.float32), ne)


def _int(v, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.int64), device=device)


def stack_cohorts(samplers: Sequence[CohortSampler]) -> CohortSampler:
    """Stack same-structure samplers on a new leading sweep axis.

    All samplers must agree on ``kind`` and ``n_max`` (pad to a common
    ``n_max`` first: that is what the padded axis is for)."""
    samplers = list(samplers)
    if not samplers:
        raise ValueError("need at least one CohortSampler to stack")
    auxs = {(s.kind, s.n_max) for s in samplers}
    if len(auxs) > 1:
        raise ValueError(
            f"cannot stack heterogeneous samplers ({sorted(auxs)}); pad to "
            "a common n_max and use one kind")
    if any(s.is_stacked for s in samplers):
        raise ValueError("samplers are already sweep-stacked")
    return dataclasses.replace(samplers[0], **{
        f: torch.stack([getattr(s, f) for s in samplers]) for f in _LEAVES
        if getattr(samplers[0], f) is not None})


def pad_plan(plan: MixPlan, n_max: int, n: int | None = None) -> MixPlan:
    """Embed an (n, n) plan into the padded (n_max, n_max) dense form.

    The padded block is the identity: padding rows hold their value under
    any mix, and their zero W entries keep them out of every active row's
    sum.  Non-dense plans densify first (``n`` required for circulant).
    Per-size graphs padded to one ``n_max`` stack into a single
    ``(S, n_max, n_max)`` leaf.
    """
    if plan.is_stacked:
        raise ValueError("pad_plan expects an unstacked plan; pad per point "
                         "then stack_mixplans")
    if plan.kind != "dense":
        plan = as_dense(plan, n)
    n0 = int(plan.W.shape[-1])
    if n0 > int(n_max):
        raise ValueError(f"plan has n={n0} > n_max={n_max}")
    if n0 == int(n_max):
        return plan
    W = torch.zeros((int(n_max), int(n_max)), dtype=plan.W.dtype,
                    device=plan.W.device)
    W[:n0, :n0] = plan.W
    pad = torch.arange(n0, int(n_max), device=W.device)
    W[pad, pad] = 1.0
    return MixPlan(kind="dense", W=W)
