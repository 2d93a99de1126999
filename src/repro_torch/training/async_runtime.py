"""Asynchronous federated runtime: actor/learner split with bounded
staleness (port of ``repro/training/async_runtime.py``).

:class:`~repro_torch.training.train_loop.FederatedTrainer` is
bulk-synchronous: every client advances in lockstep, so each round
barriers on the slowest client.  This module adds the *time* side that
the ``lazy`` schedules' *graph* side already models: client actors
produce local-step work continuously, a learner applies gossip over
whichever subset has **arrived**, and work older than a staleness bound τ
is rejected or down-weighted.

Two execution modes share one round program and one admission policy:

* :meth:`AsyncTrainer.run` — **deterministic virtual time.**  A discrete-
  event loop advances a virtual clock: each client's work item completes
  ``StragglerModel.delay(client, work_round)`` after dispatch, learner round
  ``k`` closes at ``T_k = max(T_{k-1} + window, earliest pending arrival)``
  (the second term skips ahead so an all-slow cohort can never deadlock the
  learner), and every arrival/rejection/application is appended to a replay
  log.  Delays are pure functions of ``(seed, client, work_round)``, so the
  whole schedule is **replay-deterministic**: same seeds ⇒ identical event
  order and identical trajectories, and the event log and clock equal the
  reference's (host arithmetic on the same draws).
* :meth:`AsyncTrainer.run_threaded` — **wall-clock smoke.**  One OS thread
  per client actor sleeps its scaled delay and posts to the learner queue.
  Arrival order is OS-dependent (no replay guarantee); the admission
  invariants — bounded staleness, duplicate rejection, liveness under dead
  clients — hold identically, and a hard ``deadline_s`` turns any hang into
  an exception.  The actors only sleep and post: every device launch stays
  on the calling (learner) thread.

**Deferred execution.**  Client rows live in one stacked
:class:`~repro_torch.core.depositum.DepositumState` bank, and a pending
client's row is — by construction — untouched between dispatch and
arrival (a row only changes when its own work is applied: the round
program freezes non-cohort rows, and the lazy-masked mixing matrix zeroes
their contributions to everyone else, so nobody reads them either).  The
driver therefore *defers* each work item's computation to its arrival
instant and executes the whole cohort as ONE masked
``local_then_comm_round``.  Its staleness weights are the single
``active`` row of a ``lazy`` :class:`~repro_torch.core.schedule.
MixSchedule` and the round's explicit ``active_mask``; with the fused
kernels on, that mask is the kernels' cohort gate on every step (the lazy
mix of that row gives a frozen row's column weight 0, so the gate rides
in the kernels on the comm step too) and a donated round frees the old
trees as it goes.  With τ=0 and a zero-delay straggler model every round
applies the full cohort with an all-ones mask, the lazy matrix of an
all-ones row **is** W bit for bit, the gated kernels' live rows compute
what the ungated ones do, and the async trajectory equals the
synchronous trainer's exactly (pinned by ``tests/test_torch_async.py``).
``downweight`` policies feed fractional weights straight into the same
mask: the kernels gate on ``mask > 0`` and the lazy matrix multiplies by
the weights.
Telemetry rides the existing ``repro_torch.obs`` recorder — the
``staleness`` column of :data:`~repro_torch.obs.metrics.DEFAULT_METRICS`.
"""
from __future__ import annotations

import dataclasses
import math
import queue
import threading
import time
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import DepositumState, Hyper, local_then_comm_round
from repro_torch.core.mixing import MixPlan, as_dense, validate_plan
from repro_torch.core.schedule import MixSchedule
from repro_torch.core.staleness import StalenessPolicy, StragglerModel
from repro_torch.launch.mesh import client_axis
from repro_torch.launch.steps import make_value_grad_fn
from repro_torch.models.registry import Model
from repro_torch.obs.metrics import round_values
from repro_torch.obs.record import Telemetry
from repro_torch.obs.trace import block_until_ready
from repro_torch.training.backends import ExecutionBackend, suggest_backend
from repro_torch.training.sweep import _map
from repro_torch.training.train_loop import (
    FederatedTrainer,
    TrainerConfig,
    client_mean_loss,
)


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Learner-side async knobs: the staleness policy + the round window.

    ``window`` is the learner's virtual-time round length (how long round k
    collects arrivals past the previous close); ``None`` uses the straggler
    model's nominal mean delay (or 1.0 when that is zero).  The policy
    fields mirror :class:`~repro_torch.core.staleness.StalenessPolicy`.
    """

    tau: int = 0
    mode: str = "reject"          # reject | downweight
    decay: float = 0.5
    window: Optional[float] = None

    def policy(self) -> StalenessPolicy:
        return StalenessPolicy(tau=self.tau, mode=self.mode,
                               decay=self.decay)


def tabulate_batches(batch_iter: Iterator[Any], n_rounds: int
                     ) -> Callable[[int], Any]:
    """Pre-draw ``n_rounds`` batches into a random-access ``batch_fn``.

    The async driver needs per-*work-round* batch access (a straggler may
    apply round-3 work while the learner is on round 7), so it takes a
    callable ``round -> batches`` rather than an iterator.  This adapter
    turns any synchronous batch iterator into one, clamping past the end —
    handing the SAME per-round batches to a :class:`FederatedTrainer` run
    is what the bit-exact sync-equivalence tests do.
    """
    rounds = [next(batch_iter) for _ in range(n_rounds)]

    def batch_fn(r: int):
        return rounds[min(r, n_rounds - 1)]

    return batch_fn


class AsyncTrainer:
    """Actor/learner DEPOSITUM driver with bounded staleness τ.

    Lives beside :class:`~repro_torch.training.train_loop.FederatedTrainer`
    and shares its state construction, consensus and history cadence
    (``init_state``, ``state_from_params`` — a module becomes the template
    on ``meta`` — ``mean_params``, ``_logged_rounds``); gradients come from
    the same :func:`repro_torch.launch.steps.make_value_grad_fn` and the
    round is the same ``local_then_comm_round``, with the staleness-weight
    mask as a ``lazy`` schedule's ``active`` row and as the round's
    ``active_mask``.  The plan densifies up front (masked dense gossip).
    Everything lives on ``device`` (default the card; ``"cpu"`` runs the
    kernels' plain versions).
    """

    def __init__(self, model: Model, cfg: TrainerConfig, *,
                 straggler: StragglerModel,
                 async_cfg: Optional[AsyncConfig] = None,
                 backend: Optional[ExecutionBackend] = None,
                 telemetry: Telemetry | bool | None = None,
                 plan: Optional[MixPlan] = None, device="cuda"):
        self.model = model
        self.cfg = cfg
        self.device = resolve_device(device)
        self.async_cfg = async_cfg or AsyncConfig()
        self.policy = self.async_cfg.policy()
        if straggler.n != cfg.n_clients:
            raise ValueError(f"straggler models {straggler.n} clients but "
                             f"cfg.n_clients={cfg.n_clients}")
        self.straggler = straggler
        if plan is None:
            plan = MixPlan.from_topology(cfg.topology, cfg.n_clients,
                                         device=self.device)
        if plan.kind != "dense":
            plan = as_dense(plan, cfg.n_clients, device=self.device)
        validate_plan(plan, cfg.n_clients)
        self.plan = plan.to(self.device)
        # the round program's mixing operand: a lazy schedule whose single
        # ``active`` row is this round's staleness-weight mask; all-ones
        # reproduces W bit for bit
        self._sched0 = MixSchedule(
            kind="lazy", plan=self.plan,
            active=torch.ones((1, cfg.n_clients), dtype=torch.float32,
                              device=self.device))
        self._mix_operand = self._sched0       # read by state_from_params
        self.backend = backend or suggest_backend(self.plan, cfg.n_clients)
        self._template = None
        self._grad_fn = make_value_grad_fn(model)
        if telemetry is True:
            telemetry = Telemetry.memory()
        self.telemetry = telemetry or None
        # replay artifacts of the last run()
        self.events: list[dict] = []
        self.virtual_time: float = 0.0

    # shared verbatim with the synchronous trainer
    init_state = FederatedTrainer.init_state
    state_from_params = FederatedTrainer.state_from_params
    mean_params = FederatedTrainer.mean_params
    _logged_rounds = FederatedTrainer._logged_rounds

    @property
    def window(self) -> float:
        """Resolved learner window (virtual time units)."""
        if self.async_cfg.window is not None:
            return float(self.async_cfg.window)
        return self.straggler.nominal() or 1.0

    # ------------------------------------------------------------------
    # shared admission + device-round plumbing
    # ------------------------------------------------------------------

    def _gather_batches(self, batch_fn, cohort: dict):
        """Batches for a mixed-work-round cohort: per-client columns.

        Fast path — every applied client is on the same work round (always
        true at τ=0/zero delay): that round's batches verbatim, which keeps
        the sync-equivalence comparison operating on identical tensors.
        Otherwise a copy of the first round's batches with each later
        client's column (axis 1, leaves ``(T0, n, B, ...)``, token or float)
        taken from its own work round.  Frozen clients' columns are
        discarded by the mask, so their content is irrelevant.
        """
        rounds = sorted({wr for wr, _w, _s in cohort.values()})
        base = batch_fn(rounds[0] if rounds else 0)
        if len(rounds) <= 1:
            return base
        cache = {r: batch_fn(r) for r in rounds}
        out = _map(lambda v: torch.as_tensor(v).clone(), base)
        for c in sorted(cohort):
            wr = cohort[c][0]
            if wr == rounds[0]:
                continue

            def put(o, s, col=c):
                o[:, col] = torch.as_tensor(s)[:, col]
                return o

            out = _map(put, out, cache[wr])
        return out

    def _apply_cohort(self, state, carry, cohort: dict, batch_fn, force,
                      hp=None, donate: bool = False):
        """Run ONE masked round program for this tick's applied cohort.

        ``cohort`` maps client -> (work_round, weight, staleness); an empty
        cohort still runs (all rows frozen, ``t`` advances — the shared
        iteration counter) so telemetry records the degraded round.
        """
        n = self.cfg.n_clients
        w = np.zeros(n, np.float32)
        applied = np.zeros(n, np.float32)
        stal = 0.0
        for c, (_wr, wt, s) in cohort.items():
            w[c] = wt
            applied[c] = 1.0
            stal += s
        stal = stal / len(cohort) if cohort else 0.0
        batches = self._gather_batches(batch_fn, cohort)
        sched = dataclasses.replace(
            self._sched0, active=torch.from_numpy(w)[None].to(self.device))
        dep = self.cfg.depositum
        # masks and batches are drawn for every client; a sharded client
        # axis takes this process's rows
        axis = client_axis(self.backend)
        state, aux = local_then_comm_round(
            state, axis.take(batches, dim=1), self._grad_fn,
            dep, self.backend.mixer_for(sched),
            active_mask=axis.take(sched.active[0]), donate=donate)
        if self.telemetry is not None:
            # reads the post-round state; writes its buffer only
            vals = round_values(
                state, dep, hyper=hp, mixer=sched, aux=aux,
                active_mask=torch.from_numpy(applied).to(self.device),
                n=n, staleness=stal, axis=axis)
            carry = self.telemetry.record_and_emit(
                carry, vals, (state.t - 1) // dep.comm_period,
                self.cfg.log_every, force=force)
        return state, aux, carry, stal

    def _admit(self, k: int, client: int, work_round: int,
               dispatch_round: int, applied: set, cohort: dict):
        """Admission decision for one arrival at learner round ``k``.

        Returns ``(verdict, staleness)`` with verdict in
        ``apply | duplicate | stale``.  An update is applied iff its
        dispatch age ``s = k - dispatch_round`` is within τ AND its
        (client, work_round) has never been applied — the bounded-staleness
        and exactly-once invariants the tests property-check.
        """
        s = k - dispatch_round
        if (client, work_round) in applied or client in cohort:
            return "duplicate", s
        if not self.policy.admits(s):
            return "stale", s
        return "apply", s

    # ------------------------------------------------------------------
    # deterministic virtual-time mode
    # ------------------------------------------------------------------

    def run(self, state: DepositumState, batch_fn: Callable[[int], Any],
            n_rounds: int, *, donate: bool = False
            ) -> tuple[DepositumState, list[dict]]:
        """Drive ``n_rounds`` learner rounds of deterministic virtual time.

        ``batch_fn(work_round)`` returns that work round's batches (leaves
        ``(T0, n, B, ...)`` on the trainer's device) — see
        :func:`tabulate_batches`.  Returns ``(state, history)`` like
        ``FederatedTrainer.run``; the replay log lands in ``self.events``
        (one dict per dispatch / apply / reject / drop / tick, in event
        order) and the final virtual clock in ``self.virtual_time``.
        ``donate=True`` gives ``state`` up to the first round, as
        ``FederatedTrainer.run`` does.
        """
        if not callable(batch_fn):
            raise TypeError("batch_fn must be a callable round -> batches; "
                            "wrap an iterator with tabulate_batches(...)")
        n = self.cfg.n_clients
        sm = self.straggler
        window = self.window
        events: list[dict] = []
        self.events = events
        tel = self.telemetry
        carry = hp = None
        if tel is not None:
            carry = tel.init_carry(device=self.device)
            hp = Hyper(*(v.to(self.device)
                         for v in self.cfg.depositum.hyper()))
        applied: set = set()
        wr_next = [0] * n          # each client's next work_round counter
        pending: dict = {}          # client -> in-flight primary work item
        dups: list = []             # duplicate copies still in flight

        def dispatch(client: int, for_round: int, t: float):
            wr = wr_next[client]
            wr_next[client] += 1
            item = {"client": client, "work_round": wr,
                    "dispatch_round": for_round,
                    "ready_at": t + sm.delay(client, wr),
                    "dropped": sm.dropped(client, wr), "copy": False}
            pending[client] = item
            if sm.duplicated(client, wr):
                dups.append({**item, "copy": True, "dropped": False,
                             "ready_at": item["ready_at"]
                             + sm.dup_lag(client, wr)})
            events.append({"type": "dispatch", "t": t, "round": for_round,
                           "client": client, "work_round": wr})

        t_now = 0.0
        for c in range(n):
            dispatch(c, 0, t_now)

        history: list[dict] = []
        by_round: dict[int, dict] = {}
        logged = set(self._logged_rounds(n_rounds))
        t0 = time.perf_counter()
        for k in range(n_rounds):
            ready = [p["ready_at"] for p in pending.values()
                     if math.isfinite(p["ready_at"])]
            ready += [d["ready_at"] for d in dups
                      if math.isfinite(d["ready_at"])]
            if not ready:
                raise RuntimeError(
                    f"async learner round {k}: every in-flight work item "
                    f"belongs to a dead client (dead={sm.dead}) — raising "
                    "instead of waiting forever")
            # close the window; skip ahead to the earliest arrival so an
            # all-slow cohort advances instead of spinning empty rounds
            t_k = max(t_now + window, min(ready))
            arrivals = sorted(
                [p for p in pending.values() if p["ready_at"] <= t_k]
                + [d for d in dups if d["ready_at"] <= t_k],
                key=lambda e: (e["ready_at"], e["client"], e["work_round"],
                               e["copy"]))
            cohort: dict = {}
            redispatch: list[int] = []
            for e in arrivals:
                c, wr = e["client"], e["work_round"]
                s = k - e["dispatch_round"]
                if e["copy"]:
                    # at-least-once delivery: the second copy is always
                    # rejected — the primary lifecycle owns the work item
                    dups.remove(e)
                    events.append({"type": "reject", "t": e["ready_at"],
                                   "round": k, "client": c, "work_round": wr,
                                   "staleness": s, "reason": "duplicate"})
                    continue
                del pending[c]
                if e["dropped"]:
                    events.append({"type": "drop", "t": e["ready_at"],
                                   "round": k, "client": c,
                                   "work_round": wr})
                    redispatch.append(c)
                    continue
                verdict, s = self._admit(k, c, wr, e["dispatch_round"],
                                         applied, cohort)
                if verdict != "apply":
                    events.append({"type": "reject", "t": e["ready_at"],
                                   "round": k, "client": c, "work_round": wr,
                                   "staleness": s, "reason": verdict})
                    redispatch.append(c)
                    continue
                cohort[c] = (wr, self.policy.weight(s), s)
                applied.add((c, wr))
                events.append({"type": "apply", "t": e["ready_at"],
                               "round": k, "client": c, "work_round": wr,
                               "staleness": s,
                               "weight": self.policy.weight(s)})

            state, aux, carry, stal = self._apply_cohort(
                state, carry, cohort, batch_fn, k == n_rounds - 1, hp,
                donate)
            events.append({"type": "tick", "round": k, "t": t_k,
                           "cohort": sorted(cohort),
                           "staleness_mean": stal})
            # applied and rejected-stale clients go back to work; stragglers
            # whose work is still in flight stay pending
            for c in sorted(set(redispatch) | set(cohort)):
                dispatch(c, k + 1, t_k)
            t_now = t_k

            if (k + 1) in logged:
                rec = {"round": k + 1,
                       "wall_s": time.perf_counter() - t0,
                       "virtual_t": t_k, "cohort_size": len(cohort)}
                loss = None
                if isinstance(aux, dict):
                    loss = aux.get("ce", aux.get("loss"))
                if loss is not None:
                    rec["loss"] = client_mean_loss(loss, self.backend)
                by_round[k + 1] = rec
                history.append(rec)

        self.virtual_time = t_now
        block_until_ready(state)
        if tel is not None:
            for event in tel.events(0):
                rec = by_round.get(event["round"])
                if rec is not None:
                    rec.update((kk, v) for kk, v in event.items()
                               if kk not in ("config", "round"))
        return state, history

    # ------------------------------------------------------------------
    # wall-clock threaded mode (liveness smoke; no replay guarantee)
    # ------------------------------------------------------------------

    def run_threaded(self, state: DepositumState,
                     batch_fn: Callable[[int], Any], n_rounds: int, *,
                     time_scale: float = 0.02, deadline_s: float = 60.0
                     ) -> tuple[DepositumState, list[dict]]:
        """Actor threads + wall-clock windows: the nondeterministic smoke.

        Each client actor sleeps ``delay * time_scale`` seconds then posts
        to the learner queue; the learner collects per wall-clock window
        (extending while empty) and applies the same admission policy as
        :meth:`run`.  Dead clients simply never post — liveness comes from
        the window, and ``deadline_s`` bounds the WHOLE run: on expiry the
        learner stops the actors and raises.  Returns ``(state, events)``;
        telemetry is not recorded in this mode (use :meth:`run`).  Every
        round runs on the calling thread.
        """
        n = self.cfg.n_clients
        sm = self.straggler
        pol = self.policy
        window_s = max(self.window * time_scale, 1e-3)
        arrivals: queue.Queue = queue.Queue()
        boxes = [queue.Queue() for _ in range(n)]
        stop = threading.Event()

        def actor(c: int):
            while not stop.is_set():
                try:
                    job = boxes[c].get(timeout=0.05)
                except queue.Empty:
                    continue
                if job is None:
                    return
                wr, kd = job
                d = sm.delay(c, wr)
                if not math.isfinite(d):
                    continue   # dead client: computes forever, never posts
                time.sleep(min(d * time_scale, deadline_s))
                if sm.dropped(c, wr):
                    arrivals.put(("drop", c, wr, kd))
                    continue
                arrivals.put(("arrive", c, wr, kd))
                if sm.duplicated(c, wr):
                    arrivals.put(("dup", c, wr, kd))

        threads = [threading.Thread(target=actor, args=(c,), daemon=True)
                   for c in range(n)]
        for th in threads:
            th.start()
        events: list[dict] = []
        applied: set = set()
        wr_next = [0] * n
        deadline = time.monotonic() + deadline_s

        def dispatch(c: int, for_round: int):
            wr = wr_next[c]
            wr_next[c] += 1
            boxes[c].put((wr, for_round))
            events.append({"type": "dispatch", "round": for_round,
                           "client": c, "work_round": wr})

        try:
            if len(sm.dead) >= n:
                raise RuntimeError("every client is dead; nothing can "
                                   "ever arrive")
            for c in range(n):
                dispatch(c, 0)
            for k in range(n_rounds):
                cohort: dict = {}
                round_deadline = time.monotonic() + window_s
                while True:
                    now = time.monotonic()
                    if now >= deadline:
                        raise RuntimeError(
                            f"async run exceeded deadline_s={deadline_s} "
                            f"at learner round {k}")
                    if cohort and now >= round_deadline:
                        break
                    try:
                        kind, c, wr, kd = arrivals.get(
                            timeout=min(max(round_deadline - now, 1e-3),
                                        deadline - now))
                    except queue.Empty:
                        continue   # window empty so far: keep collecting
                    s = k - kd
                    if kind == "drop":
                        events.append({"type": "drop", "round": k,
                                       "client": c, "work_round": wr})
                        dispatch(c, k + 1)
                        continue
                    if kind == "dup":
                        events.append({"type": "reject", "round": k,
                                       "client": c, "work_round": wr,
                                       "staleness": s,
                                       "reason": "duplicate"})
                        continue
                    verdict, s = self._admit(k, c, wr, kd, applied, cohort)
                    if verdict != "apply":
                        events.append({"type": "reject", "round": k,
                                       "client": c, "work_round": wr,
                                       "staleness": s, "reason": verdict})
                        dispatch(c, k + 1)
                        continue
                    cohort[c] = (wr, pol.weight(s), s)
                    applied.add((c, wr))
                    events.append({"type": "apply", "round": k, "client": c,
                                   "work_round": wr, "staleness": s,
                                   "weight": pol.weight(s)})
                tel, self.telemetry = self.telemetry, None
                try:
                    state, _aux, _carry, stal = self._apply_cohort(
                        state, None, cohort, batch_fn, False)
                finally:
                    self.telemetry = tel
                events.append({"type": "tick", "round": k,
                               "cohort": sorted(cohort),
                               "staleness_mean": stal})
                for c in sorted(cohort):
                    dispatch(c, k + 1)
        finally:
            stop.set()
            for box in boxes:
                box.put(None)
            for th in threads:
                th.join(timeout=1.0)
        block_until_ready(state)
        return state, events
