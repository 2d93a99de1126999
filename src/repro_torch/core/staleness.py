"""Staleness policy + seedable straggler models for the async runtime.

Port of ``repro/core/staleness.py`` (numpy only; the port keeps its own
copy).  The async driver (:mod:`repro_torch.training.async_runtime`)
separates *what the round program computes* (the DEPOSITUM round,
untouched) from *when each client's work arrives*.  This module owns the
"when":

* :class:`StragglerModel` — per-(client, work_round) virtual delays drawn
  from a named distribution (``zero`` | ``deterministic`` | ``exponential``
  | ``heavytail``), plus fault knobs: arrivals dropped with ``p_drop``,
  duplicated with ``p_dup``, and a ``dead`` set of clients that never
  report.  Every draw is keyed by ``(seed, stream, client, work_round)``
  through :func:`numpy.random.default_rng`, so delays are a pure function
  of their arguments — independent of call order, and equal to the
  reference's bit for bit — which is what makes an async schedule
  *replayable*: same seeds ⇒ same event log.
* :class:`StalenessPolicy` — bounded staleness τ: an arrival whose work was
  dispatched ``s`` learner rounds ago is admitted iff ``s <= tau``; admitted
  arrivals mix with weight 1 (``reject`` mode) or ``decay**s``
  (``downweight`` mode — the fractional weight feeds the lazy mixing mask,
  whose rows stay stochastic for any weights in [0, 1]).
* Replay-log helpers (:func:`replay_staleness`, :func:`replay_cohorts`,
  :func:`check_bounded_staleness`, :func:`sync_virtual_time`) — post-hoc
  recomputations over the driver's event log, shared by the telemetry
  equivalence tests and the throughput figure so "recorded" and
  "replayed" are the same computation.

Everything here runs on the host between device rounds; only the
resulting (n,) weight mask reaches the device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np

KINDS = ("zero", "deterministic", "exponential", "heavytail")

# rng stream tags: each (client, work_round) decision draws from its own
# counter-keyed stream so adding a fault knob never shifts delay draws.
_S_DELAY, _S_DROP, _S_DUP, _S_LAG = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class StragglerModel:
    """Seedable virtual-time delay model, one draw per (client, work item).

    ``scale`` is the per-client *mean* delay (virtual time units) for every
    kind — ``heavytail`` draws are Lomax(``shape``) rescaled to the same
    mean, so distributions are throughput-comparable at equal ``scale``.
    ``dead`` clients have infinite delay: they dispatch but never arrive.
    """

    kind: str
    scale: Tuple[float, ...]
    seed: int = 0
    shape: float = 2.5           # heavytail Pareto/Lomax tail index (> 1)
    p_drop: float = 0.0          # arrival lost in flight; client retries
    p_dup: float = 0.0           # arrival delivered twice (at-least-once)
    dead: Tuple[int, ...] = ()   # clients that never report

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"kind {self.kind!r} not in {KINDS}")
        if self.kind == "heavytail" and self.shape <= 1.0:
            raise ValueError(f"heavytail needs shape > 1 (finite mean), "
                             f"got {self.shape}")
        if any(s < 0 for s in self.scale):
            raise ValueError(f"negative delay scale: {self.scale}")
        for p, name in ((self.p_drop, "p_drop"), (self.p_dup, "p_dup")):
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        if any(not 0 <= c < self.n for c in self.dead):
            raise ValueError(f"dead clients {self.dead} outside "
                             f"[0, {self.n})")

    # -- constructors -------------------------------------------------------
    @classmethod
    def zero(cls, n: int, **kw) -> "StragglerModel":
        """Degenerate model: every arrival is instantaneous.  With τ=0 the
        async driver reproduces the synchronous trainer bit for bit."""
        return cls(kind="zero", scale=(0.0,) * n, **kw)

    @classmethod
    def deterministic(cls, delays: Sequence[float], **kw) -> "StragglerModel":
        """Fixed per-client delays (heterogeneous but noise-free)."""
        return cls(kind="deterministic",
                   scale=tuple(float(d) for d in delays), **kw)

    @classmethod
    def exponential(cls, mean, n: Optional[int] = None, *,
                    seed: int = 0, **kw) -> "StragglerModel":
        """Exponential delays; ``mean`` is a scalar or per-client sequence."""
        scale = ((float(mean),) * n if np.isscalar(mean)
                 else tuple(float(m) for m in mean))
        return cls(kind="exponential", scale=scale, seed=seed, **kw)

    @classmethod
    def heavytail(cls, mean, n: Optional[int] = None, *, seed: int = 0,
                  shape: float = 2.5, **kw) -> "StragglerModel":
        """Lomax (shifted-Pareto) delays rescaled to the given mean."""
        scale = ((float(mean),) * n if np.isscalar(mean)
                 else tuple(float(m) for m in mean))
        return cls(kind="heavytail", scale=scale, seed=seed, shape=shape,
                   **kw)

    def with_faults(self, *, p_drop: Optional[float] = None,
                    p_dup: Optional[float] = None,
                    dead: Optional[Sequence[int]] = None) -> "StragglerModel":
        """Same delay law, different fault knobs (delay draws unchanged)."""
        return dataclasses.replace(
            self,
            p_drop=self.p_drop if p_drop is None else p_drop,
            p_dup=self.p_dup if p_dup is None else p_dup,
            dead=self.dead if dead is None else tuple(sorted(dead)))

    # -- draws --------------------------------------------------------------
    @property
    def n(self) -> int:
        return len(self.scale)

    def _rng(self, stream: int, client: int, work_round: int):
        return np.random.default_rng(
            (self.seed, stream, client, work_round))

    def delay(self, client: int, work_round: int) -> float:
        """Virtual compute+upload time of this work item (inf if dead)."""
        if client in self.dead:
            return math.inf
        s = self.scale[client]
        if self.kind == "zero":
            return 0.0
        if self.kind == "deterministic":
            return s
        rng = self._rng(_S_DELAY, client, work_round)
        if self.kind == "exponential":
            return float(rng.exponential(s)) if s > 0 else 0.0
        # heavytail: (pareto(a)+1) has mean a/(a-1); rescale to mean s
        draw = float(rng.pareto(self.shape)) + 1.0
        return draw * s * (self.shape - 1.0) / self.shape

    def dropped(self, client: int, work_round: int) -> bool:
        """Whether this work item's arrival is lost in flight."""
        return (self.p_drop > 0.0
                and float(self._rng(_S_DROP, client, work_round).random())
                < self.p_drop)

    def duplicated(self, client: int, work_round: int) -> bool:
        """Whether this arrival is delivered a second time."""
        return (self.p_dup > 0.0
                and float(self._rng(_S_DUP, client, work_round).random())
                < self.p_dup)

    def dup_lag(self, client: int, work_round: int) -> float:
        """Extra in-flight time of the duplicate copy (deterministic)."""
        nominal = self.scale[client] or self.nominal() or 1.0
        return float(self._rng(_S_LAG, client, work_round).uniform(
            0.0, 2.0 * nominal))

    def nominal(self) -> float:
        """Mean per-client delay — the driver's default learner window."""
        return float(np.mean(self.scale)) if self.scale else 0.0


@dataclasses.dataclass(frozen=True)
class StalenessPolicy:
    """Bounded staleness τ and how admitted-but-old work is weighted.

    ``mode="reject"``: arrivals with age ``s <= tau`` mix at full weight,
    older ones are rejected (and their clients redispatch fresh work).
    ``mode="downweight"``: admitted arrivals mix with ``decay**s`` — the
    fractional weight flows into the lazy mixing mask, which stays row
    stochastic for weights in [0, 1] (see ``core.schedule``).
    """

    tau: int = 0
    mode: str = "reject"
    decay: float = 0.5

    def __post_init__(self):
        if self.tau < 0:
            raise ValueError(f"tau must be >= 0, got {self.tau}")
        if self.mode not in ("reject", "downweight"):
            raise ValueError(f"mode {self.mode!r} not in "
                             "('reject', 'downweight')")
        if not 0.0 < self.decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {self.decay}")

    def admits(self, staleness: int) -> bool:
        return staleness <= self.tau

    def weight(self, staleness: int) -> float:
        """Mixing weight of an *admitted* arrival of the given age."""
        if self.mode == "reject":
            return 1.0
        return float(self.decay ** staleness)


# ---------------------------------------------------------------------------
# Replay-log recomputations (the post-hoc twins of the recorded streams)
# ---------------------------------------------------------------------------

def replay_staleness(events: Sequence[dict]) -> list:
    """Per-learner-round mean staleness of *applied* arrivals, from the log.

    The post-hoc twin of the recorder's ``staleness`` stream: rounds with an
    empty cohort recompute to 0.0, matching ``round_values(staleness=None)``.
    """
    n_rounds = 1 + max((e["round"] for e in events if e["type"] == "apply"
                        or e["type"] == "tick"), default=-1)
    sums = [0.0] * n_rounds
    counts = [0] * n_rounds
    for e in events:
        if e["type"] == "apply":
            sums[e["round"]] += e["staleness"]
            counts[e["round"]] += 1
    return [s / c if c else 0.0 for s, c in zip(sums, counts)]


def replay_cohorts(events: Sequence[dict]) -> list:
    """Applied client lists per learner round (arrival order preserved)."""
    n_rounds = 1 + max((e["round"] for e in events if e["type"] == "apply"
                        or e["type"] == "tick"), default=-1)
    cohorts: list = [[] for _ in range(n_rounds)]
    for e in events:
        if e["type"] == "apply":
            cohorts[e["round"]].append(e["client"])
    return cohorts


def check_bounded_staleness(events: Sequence[dict], tau: int) -> None:
    """Raise AssertionError unless every applied update has age <= tau and
    no (client, work_round) was applied twice — the async invariants."""
    seen = set()
    for e in events:
        if e["type"] != "apply":
            continue
        if e["staleness"] > tau:
            raise AssertionError(
                f"applied update older than tau={tau}: {e}")
        key = (e["client"], e["work_round"])
        if key in seen:
            raise AssertionError(f"(client, work_round) applied twice: {e}")
        seen.add(key)


def sync_virtual_time(straggler: StragglerModel, n_rounds: int) -> float:
    """Virtual time a *bulk-synchronous* run spends on the same delay draws.

    Each synchronous round barriers on its slowest client:
    ``Σ_r max_i delay(i, r)``.  Infinite for models with dead clients —
    the synchronous run never finishes, which is the point.
    """
    total = 0.0
    for r in range(n_rounds):
        total += max(straggler.delay(i, r) for i in range(straggler.n))
    return total
