"""Federated training loop: DEPOSITUM x model zoo x data pipeline (port of
``repro/training/train_loop.py``).

One *round* = T0-1 collective-free local iterations + 1 gossip iteration
(``local_then_comm_round``).  Per-client gradients come from
:func:`repro_torch.launch.steps.make_value_grad_fn`: the clients run one
after another through ``torch.autograd.grad`` over views of the stacked
state, so the same loop drives a least-squares toy and a full-width zoo
transformer under remat.  With ``fused`` on in the DEPOSITUM config every
step runs the two grouped sweep kernels.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.core import (
    DepositumConfig,
    DepositumState,
    Hyper,
    init as dep_init,
    local_then_comm_round,
)
from repro_torch.core.mixing import MixPlan, validate_plan
from repro_torch.core.schedule import MixSchedule, validate_schedule
from repro_torch.launch.mesh import client_axis
from repro_torch.launch.steps import make_value_grad_fn
from repro_torch.models.registry import Model
from repro_torch.obs.metrics import round_values
from repro_torch.obs.record import Telemetry
from repro_torch.obs.trace import RoundTimer, annotate, profile_capture
from repro_torch.training.backends import ExecutionBackend, suggest_backend


@dataclasses.dataclass
class TrainerConfig:
    n_clients: int = 10
    topology: str = "ring"
    depositum: DepositumConfig = dataclasses.field(default_factory=DepositumConfig)
    seed: int = 0
    log_every: int = 10


class FederatedTrainer:
    """Drives DEPOSITUM rounds for a model on stacked client batches.

    Mixing resolves in priority order: an explicit ``mixer`` closure, else
    a round-indexed ``schedule`` (:class:`~repro_torch.core.schedule.
    MixSchedule` — time-varying topologies, partial participation,
    per-round ``cohort`` sampling over a padded client axis, Chebyshev
    rounds, compressed gossip), else a static plan built from
    ``cfg.topology``.  For a ``cohort`` schedule ``cfg.n_clients`` is the
    *padded* axis length ``n_max``.  With ``backend=None`` the backend is
    :func:`~repro_torch.training.backends.suggest_backend`'s (one process
    is one device: the stacked simulation).  A ``ShardMapBackend`` puts
    this process's block of the client axis in the state: the batch
    iterator still yields every client, the trainer takes its rows, and
    the logged loss, the recorded metrics and :meth:`mean_params` reduce
    over the group.

    The model's ``init(seed)`` gives its parameters: an ``nn.Module`` (the
    zoo's) becomes its ``named_parameters`` dict, and the gradients run
    the module through ``functional_call``; a dict is used as it is.  Once
    the state holds the parameters, the module's own weights move to
    ``meta`` (at full width they would hold a client's worth of memory for
    the whole run); :meth:`mean_params` gives a module back.

    Everything lives on ``device`` (default the card; ``"cpu"`` runs the
    kernels' plain versions).  ``telemetry`` (a :class:`~repro_torch.obs.
    record.Telemetry`, or True for an in-memory one) records the round's
    theory metrics (:func:`~repro_torch.obs.metrics.round_values`) on the
    device after every round at ``cfg.log_every`` (the final round
    always); it reads the post-round state only, so the trajectory is bit
    for bit the one without it.
    """

    def __init__(self, model: Model, cfg: TrainerConfig, mixer=None,
                 backend: ExecutionBackend | None = None,
                 schedule: MixSchedule | None = None,
                 telemetry: Telemetry | bool | None = None, *,
                 device="cuda"):
        self.model = model
        self.cfg = cfg
        self.device = resolve_device(device)
        plan = MixPlan.from_topology(cfg.topology, cfg.n_clients,
                                     device=self.device)
        validate_plan(plan, cfg.n_clients)
        self.plan = plan
        self.W = None if plan.W is None else plan.W.cpu().numpy()
        self.schedule = schedule
        if schedule is not None:
            if (schedule.kind == "cohort"
                    and schedule.sampler.n_max != cfg.n_clients):
                raise ValueError(
                    f"cohort schedule pads to n_max="
                    f"{schedule.sampler.n_max} but cfg.n_clients="
                    f"{cfg.n_clients}; the trainer's client axis must be "
                    "the padded length")
            validate_schedule(schedule, cfg.n_clients)
            schedule = schedule.to(self.device)
        operand = schedule if schedule is not None else plan
        self._mix_operand = operand
        backend = backend or suggest_backend(operand, cfg.n_clients)
        self.backend = backend
        self.mixer = (mixer if mixer is not None
                      else backend.mixer_for(operand))
        self._template: Optional[nn.Module] = None
        self._grad_fn = make_value_grad_fn(model)
        if telemetry is True:
            telemetry = Telemetry.memory()
        self.telemetry = telemetry or None
        self.timer = RoundTimer()

    def _round(self, state, batches, *, donate: bool = False):
        batches = client_axis(self.backend).take(batches, dim=1)
        return local_then_comm_round(state, batches, self._grad_fn,
                                     self.cfg.depositum, self.mixer,
                                     donate=donate)

    def init_state(self, seed: int = 0) -> DepositumState:
        params, _axes = self.model.init(seed)
        return self.state_from_params(params)

    def state_from_params(self, params) -> DepositumState:
        """The initial state from given parameters (a module or a dict):
        every client starts from them.  A module becomes the trainer's
        template and moves to ``meta``.  A schedule carrying a
        compression spec gets its error-feedback memory here."""
        if isinstance(params, nn.Module):
            template = params
            params = {k: p.detach() for k, p in template.named_parameters()}
            self._template = template
            self._grad_fn = make_value_grad_fn(self.model, template=template)
        state = dep_init(params, self.cfg.n_clients,
                         compress=self._mix_operand
                         if isinstance(self._mix_operand, MixSchedule)
                         else None, device=self.device, backend=self.backend)
        if self._template is not None:
            del params
            self._template.to("meta")
        return state

    def _logged_rounds(self, n_rounds: int) -> list[int]:
        """1-based rounds that land in history: every ``log_every``-th
        plus always the final one."""
        le = max(1, self.cfg.log_every)
        rounds = [r for r in range(1, n_rounds + 1) if r % le == 0]
        if n_rounds >= 1 and n_rounds not in rounds:
            rounds.append(n_rounds)
        return rounds

    def run(
        self,
        state: DepositumState,
        batch_iter: Iterator[Any],
        n_rounds: int,
        eval_fn: Optional[Callable[[DepositumState, int], dict]] = None,
        *,
        profile_dir: Optional[str] = None,
        donate: bool = False,
    ) -> tuple[DepositumState, list[dict]]:
        """batch_iter yields dicts with leaves (T0, n_clients, B, ...).

        History has one record per :meth:`_logged_rounds` entry with
        ``round``, ``wall_s``, ``loss`` (the mean over clients of the
        model's ``ce`` aux when it has one, else of the loss) and any
        ``eval_fn`` keys; with telemetry attached, the recorded metric
        streams (consensus errors, prox-gradient norm, bytes on the wire,
        ...) merge in by round.  ``profile_dir`` opts into a ``torch.profiler``
        capture of the whole loop.  ``self.timer`` accumulates the rounds'
        dispatch and blocked times.  ``donate=True`` gives ``state`` up to
        the first round (its trees are emptied as they are consumed, and
        every later round's input likewise): the run then holds one state
        less at its peak.
        """
        tel = self.telemetry
        logged = set(self._logged_rounds(n_rounds))
        history: list[dict] = []
        by_round: dict[int, dict] = {}
        t0 = time.perf_counter()
        timer = self.timer
        if tel is not None:
            carry = tel.init_carry(device=self.device)
            hp = Hyper(*(v.to(self.device)
                         for v in self.cfg.depositum.hyper()))
        with profile_capture(profile_dir, enabled=profile_dir is not None):
            for r in range(n_rounds):
                with annotate("round"):
                    with annotate("round.batch"):
                        batches = next(batch_iter)
                    with timer.round():
                        with annotate("round.program"):
                            state, aux = self._round(state, batches,
                                                     donate=donate)
                        if tel is not None:
                            # reads the post-round state; writes its buffer
                            # only
                            vals = round_values(
                                state, self.cfg.depositum, hyper=hp,
                                mixer=self._mix_operand, aux=aux,
                                n=self.cfg.n_clients,
                                axis=client_axis(self.backend))
                            carry = tel.record_and_emit(
                                carry, vals, (state.t - 1)
                                // self.cfg.depositum.comm_period,
                                self.cfg.log_every, force=r == n_rounds - 1)
                    if (r + 1) in logged:
                        with annotate("round.log"):
                            rec = {"round": r + 1,
                                   "wall_s": time.perf_counter() - t0}
                            loss = None
                            if isinstance(aux, dict):
                                loss = aux.get("ce", aux.get("loss"))
                            if loss is not None:
                                rec["loss"] = client_mean_loss(loss,
                                                               self.backend)
                            if eval_fn is not None:
                                rec.update(eval_fn(state, r + 1))
                            by_round[r + 1] = rec
                            history.append(rec)
        with annotate("run.sync"):
            timer.block_on(state)
        if tel is not None:
            for event in tel.events(0):
                rec = by_round.get(event["round"])
                if rec is not None:
                    rec.update((k, v) for k, v in event.items()
                               if k not in ("config", "round"))
        return state, history

    def mean_params(self, state: DepositumState):
        """Consensus (client-averaged) model for evaluation/serving: a
        module like the template (on the state's device) for a module
        model, else a dict.  On a sharded client axis, the mean of every
        process's rows (the same on every process)."""
        axis = client_axis(self.backend)
        means = {k: axis.client_mean(v) for k, v in state.x.items()}
        if self._template is None:
            return means
        module = copy.deepcopy(self._template)
        module.load_state_dict(means, strict=True, assign=True)
        return module


def client_mean_loss(loss, backend=None) -> float:
    """The logged loss: the mean of the clients' losses, over every
    process's clients when ``backend`` shards the client axis."""
    v = torch.as_tensor(loss, dtype=torch.float32)
    return float(client_axis(backend).client_mean(v.reshape(-1)))


def lm_batch_iterator(stream, trainer_cfg: TrainerConfig, batch: int,
                      seq_len: int, *, device="cuda") -> Iterator[dict]:
    """Yields {"tokens","labels"} int32 tensors on ``device`` with leaves
    (T0, n, B, L) from a token stream."""
    dev = resolve_device(device)
    T0 = trainer_cfg.depositum.comm_period
    step = 0
    while True:
        block = torch.from_numpy(
            stream.stacked_round(step, T0, batch, seq_len))  # (T0,n,B,L+1)
        step += T0
        yield {
            "tokens": block[..., :-1].contiguous().to(dev),
            "labels": block[..., 1:].contiguous().to(dev),
        }


def classification_batch_iterator(dataset, trainer_cfg: TrainerConfig,
                                  batch: int, seed: int = 0, *,
                                  device="cuda") -> Iterator[dict]:
    """Yields {"x","y"} tensors on ``device`` with leaves (T0, n, B, ...)
    from a labelled dataset."""
    dev = resolve_device(device)
    T0 = trainer_cfg.depositum.comm_period
    rng = np.random.default_rng(seed)
    while True:
        xs, ys = dataset.stacked_batches(rng, batch, T0)
        yield {"x": torch.from_numpy(xs).to(dev),
               "y": torch.from_numpy(ys).to(dev)}
