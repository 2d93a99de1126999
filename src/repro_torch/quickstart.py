"""Quickstart: DEPOSITUM rounds of the paper's MLP on a 10-client ring.

Port of ``examples/quickstart.py`` and of the harness of
``benchmarks/common.py``: ``run_depositum`` runs one configuration,
``run_depositum_grid`` a grid of them through the sweep engine (one run a
group of configurations that share their structure); both record the
in-loop theory streams with ``telemetry=``.
The default configuration is the Polyak point of the paper's Fig. 4
(``benchmarks/fig4_momentum.py``):
an MLP 123 -> 64 -> 32 -> 10 (ReLU, CE loss) on synthetic classification
data with Dirichlet label skew (theta = 1.0) over 10 clients on a ring,
batch 32, T0 = 10, alpha = 0.05, beta = 0.5, gamma = 0.8 and an MCP prox
(lam = 1e-4, theta = 4).

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu] [--rounds N]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
from torch.func import functional_call

from repro_torch._device import resolve_device
from repro_torch.core import (
    DepositumConfig,
    Hyper,
    MixPlan,
    MixSchedule,
    as_schedule,
    init,
    local_then_comm_round,
    make_dense_mixer,
    mixing_matrix,
    plan_spectral_lambda,
    spectral_lambda,
    stack_hypers,
    stack_mixplans,
    stationarity_metrics,
)
from repro_torch.data import make_classification
from repro_torch.models.classifier import (
    MODELS,
    ce_loss,
    client_grad_fn,
    init_params,
    stationarity_grad_fns,
)
from repro_torch.obs.metrics import round_values

METRIC_KEYS = ("prox_grad_sq", "consensus_x", "consensus_y", "consensus_nu",
               "grad_est_err", "stationarity")


@dataclasses.dataclass
class ExperimentConfig:
    """One experiment of the paper-validation harness (defaults as the
    reference's ``ExperimentConfig``; ``hidden`` sizes the MLP)."""

    model: str = "linear"
    n_clients: int = 10
    topology: str = "ring"
    theta: float = np.inf            # Dirichlet concentration (inf = IID)
    rounds: int = 60
    batch: int = 32
    n_features: int = 123            # A9A-like
    n_classes: int = 2
    n_samples: int = 4096
    seed: int = 0
    hidden: tuple = (64, 32)
    depositum: DepositumConfig = dataclasses.field(
        default_factory=lambda: DepositumConfig(
            alpha=0.1, beta=1.0, gamma=0.5, comm_period=5,
            prox_name="l1", prox_kwargs={"lam": 1e-4})
    )


def mlp_config(rounds: int = 30, fused: str | None = None) -> ExperimentConfig:
    """The Fig. 4 Polyak point (``benchmarks/fig4_momentum.py``)."""
    return ExperimentConfig(
        model="mlp", n_clients=10, topology="ring", theta=1.0,
        n_classes=10, rounds=rounds,
        depositum=DepositumConfig(alpha=0.05, beta=0.5, gamma=0.8,
                                  momentum="polyak", comm_period=10,
                                  prox_name="mcp",
                                  prox_kwargs={"lam": 1e-4, "theta": 4.0},
                                  fused=fused))


def _model(cfg: ExperimentConfig):
    if cfg.model == "mlp":
        return MODELS["mlp"](cfg.n_features, cfg.n_classes, cfg.hidden)
    return MODELS[cfg.model](cfg.n_features, cfg.n_classes)


@dataclasses.dataclass
class Prepared:
    """Everything a run needs, built and placed on the device."""

    model: torch.nn.Module
    state: object            # DepositumState
    grad_fn: object          # per-client minibatch gradients
    grad_fns: dict           # exact gradients for stationarity_metrics
    mixer: object
    W: np.ndarray
    bx: torch.Tensor         # (rounds, T0, C, batch, d) minibatch inputs
    by: torch.Tensor         # (rounds, T0, C, batch) labels
    all_x: torch.Tensor
    all_y: torch.Tensor

    def batches(self, r: int) -> dict:
        return {"x": self.bx[r], "y": self.by[r]}


def prepare(cfg: ExperimentConfig, *, params0: dict | None = None,
            compress=None, device="cuda") -> Prepared:
    """Data, model, initial state, mixer and every round's minibatches.

    ``params0`` (name -> tensor) replaces the seeded initial weights.  The
    minibatches are drawn up front from the reference's rng stream
    (``seed + 7``) and placed on the device, so a round loop copies nothing
    from the host.  ``compress`` (a CompressionSpec) makes the mixer a
    constant schedule over the same W carrying it, and gives the state its
    error-feedback memory.
    """
    dev = resolve_device(device)
    ds = make_classification(
        n_samples=cfg.n_samples, n_features=cfg.n_features,
        n_classes=cfg.n_classes, n_clients=cfg.n_clients,
        theta=cfg.theta, seed=cfg.seed,
    )
    model = _model(cfg).to(dev)
    if params0 is None:
        params0 = init_params(model, cfg.seed, device=dev)
    xs_full = torch.from_numpy(np.stack(
        [ds.client_arrays(i)[0] for i in range(cfg.n_clients)])).to(dev)
    ys_full = torch.from_numpy(np.stack(
        [ds.client_arrays(i)[1] for i in range(cfg.n_clients)])).to(dev)
    W = mixing_matrix(cfg.topology, cfg.n_clients)
    rng = np.random.default_rng(cfg.seed + 7)
    draws = [ds.stacked_batches(rng, cfg.batch, cfg.depositum.comm_period)
             for _ in range(cfg.rounds)]
    mixer = (make_dense_mixer(W, device=dev) if compress is None else
             as_schedule(MixPlan.dense(W, device=dev)).with_compression(
                 compress.to(dev)))
    return Prepared(
        model=model,
        state=init(params0, cfg.n_clients, compress=compress, device=dev),
        grad_fn=client_grad_fn(model),
        grad_fns=stationarity_grad_fns(model, xs_full, ys_full),
        mixer=mixer, W=W,
        bx=torch.from_numpy(np.stack([d[0] for d in draws])).to(dev),
        by=torch.from_numpy(np.stack([d[1] for d in draws])).to(dev),
        all_x=xs_full.reshape(-1, cfg.n_features), all_y=ys_full.reshape(-1))


def classifier_metrics(model, grad_fns: dict, all_x: torch.Tensor,
                       all_y: torch.Tensor, config: DepositumConfig):
    """``metrics(state, hyper) -> dict`` of 0-d tensors: the stationarity
    terms and the consensus model's loss and accuracy on all the data
    (``hyper`` None reads the config's floats)."""
    def metrics(state, hyper=None):
        m = stationarity_metrics(state, grad_fns, config, hyper=hyper)
        pbar = {k: torch.mean(v, 0) for k, v in state.x.items()}
        logits = functional_call(model, pbar, (all_x,))
        m["accuracy"] = torch.mean(
            (torch.argmax(logits, -1) == all_y).to(torch.float32))
        m["loss"] = ce_loss(model, pbar, {"x": all_x, "y": all_y})
        return m

    return metrics


def _recorded(telemetry, curves: dict, config: int = 0) -> None:
    """The recorder's streams of ``config`` into ``curves`` as
    ``recorded_round`` and ``recorded_<name>`` lists."""
    sink = telemetry.memory_sink
    telemetry.sync()
    if sink is not None:
        curves["recorded_round"] = sink.rounds(config)
        for name in telemetry.spec.names:
            curves[f"recorded_{name}"] = sink.stream(name, config)


def run_depositum(cfg: ExperimentConfig, *, collect_metrics: bool = True,
                  metrics_every: int | None = None, params0: dict | None = None,
                  compress=None, telemetry=None, log_every: int = 1,
                  device="cuda"):
    """Run ``cfg.rounds`` DEPOSITUM rounds on ``device``.

    Returns ``(final_state, curves)``; ``curves`` holds per-round loss,
    accuracy and the stationarity terms every ``metrics_every`` rounds (and
    at the last), plus ``wall_s`` (the round loop, metrics included),
    ``iters`` and ``spectral_lambda``.  ``params0`` and ``compress`` as in
    :func:`prepare`.

    ``telemetry`` (a :class:`~repro_torch.obs.record.Telemetry`) also
    records the in-loop theory streams on the device every ``log_every``
    rounds (no host read a round; the exact-gradient metrics above keep
    their own cadence) and adds them to the curves as ``recorded_<name>``
    lists.
    """
    p = prepare(cfg, params0=params0, compress=compress, device=device)
    dep, state = cfg.depositum, p.state
    metrics = classifier_metrics(p.model, p.grad_fns, p.all_x, p.all_y, dep)
    curves: dict[str, list] = {k: [] for k in
                               ("round", "loss", "accuracy") + METRIC_KEYS}
    every = metrics_every if metrics_every else max(cfg.rounds // 20, 1)
    dev = p.all_x.device
    if telemetry is not None:
        # the recorder prices the gossip of the round's own operand: a
        # constant schedule over the run's W (or its compressed schedule)
        sched = (p.mixer if isinstance(p.mixer, MixSchedule) else
                 MixSchedule.constant(MixPlan.dense(p.W, device=dev)))
        hp = Hyper(*(v.to(dev) for v in dep.hyper()))
        carry = telemetry.init_carry(device=dev)
    t0 = time.perf_counter()
    for r in range(cfg.rounds):
        state, _ = local_then_comm_round(state, p.batches(r), p.grad_fn, dep,
                                         p.mixer)
        if telemetry is not None:
            vals = round_values(state, dep, hyper=hp, mixer=sched,
                                n=cfg.n_clients)
            carry = telemetry.record_and_emit(
                carry, vals, (state.t - 1) // dep.comm_period, log_every)
        if collect_metrics and (r % every == 0 or r == cfg.rounds - 1):
            m = metrics(state)
            curves["round"].append(r + 1)
            for k in ("loss", "accuracy") + METRIC_KEYS:
                curves[k].append(float(m[k]))
    if p.all_x.device.type == "cuda":
        torch.cuda.synchronize(p.all_x.device)
    curves["wall_s"] = time.perf_counter() - t0
    curves["iters"] = cfg.rounds * dep.comm_period
    curves["spectral_lambda"] = float(spectral_lambda(p.W))
    if telemetry is not None:
        _recorded(telemetry, curves)
    return state, curves


# ---------------------------------------------------------------------------
# Sweep-engine path: a whole grid as one run
# ---------------------------------------------------------------------------

def _static_key(cfg: ExperimentConfig):
    """Everything that changes the round program (the grouping key).

    Topology is not part of it: mixing is a MixPlan operand, so configs
    that differ only in their graph stack on the same sweep axis as
    configs that differ in step sizes.
    """
    d = cfg.depositum
    return (cfg.model, cfg.n_clients, cfg.theta, cfg.rounds, cfg.batch,
            cfg.n_features, cfg.n_classes, cfg.n_samples, cfg.seed,
            tuple(cfg.hidden), d.momentum, d.comm_period, d.prox_name,
            d.fused_mode())


@dataclasses.dataclass
class GridOperands:
    """The sweep engine's operands for a group of configs that share
    their structure: data and model (``prepared``, from the first config),
    the initial params, the mixing plan, the stacked Hyper and every
    round's minibatches."""

    prepared: Prepared
    params0: dict
    plan: MixPlan            # shared, or stacked (S, n, n) over topologies
    hypers: object           # Hyper of (S,) values
    batches: dict            # leaves (rounds, T0, C, batch, ...)


def grid_operands(cfgs: list[ExperimentConfig], *, params0: dict | None = None,
                  device="cuda") -> GridOperands:
    """Operands of one static-config group (:func:`_static_key`): a
    stacked Hyper axis, and a stacked dense-W plan when the topologies
    differ.  The data, initial weights and minibatches are those of
    :func:`run_depositum` on the first config (``params0`` as in
    :func:`prepare`)."""
    if len({_static_key(c) for c in cfgs}) != 1:
        raise ValueError("grid_operands takes configs of one static "
                         "structure (group them with run_depositum_grid)")
    p = prepare(cfgs[0], params0=params0, device=device)
    dev = p.all_x.device
    plans = [MixPlan.from_topology(c.topology, c.n_clients, device=dev)
             for c in cfgs]
    if len({c.topology for c in cfgs}) == 1:
        plan = plans[0]               # one graph: shared, no stacked W
    else:
        plan = stack_mixplans(plans)  # topology sweep axis: (S, n, n)
    return GridOperands(
        prepared=p, params0={k: v[0] for k, v in p.state.x.items()},
        plan=plan, hypers=stack_hypers([c.depositum.hyper() for c in cfgs]),
        batches={"x": p.bx, "y": p.by})


def _run_sweep_group(cfgs: list[ExperimentConfig], group_id: int,
                     collect_metrics: bool = True, *, backend=None,
                     params0: dict | None = None, telemetry=None,
                     log_every: int = 1, device="cuda") -> list[dict]:
    """One static-config group through the sweep engine; ``telemetry``
    records a stream a config (``config`` tags in group order), added to
    each row as ``recorded_<name>`` lists."""
    from repro_torch.training.sweep import sweep_run

    cfg = cfgs[0]
    dep = cfg.depositum
    ops = grid_operands(cfgs, params0=params0, device=device)
    p, plan = ops.prepared, ops.plan
    dev = p.all_x.device
    lambdas = plan_spectral_lambda(plan, cfg.n_clients)

    t0 = time.perf_counter()
    _final, outs = sweep_run(
        ops.params0, p.grad_fn, dep, plan, ops.hypers, ops.batches,
        n_clients=cfg.n_clients,
        metrics_fn=(classifier_metrics(p.model, p.grad_fns, p.all_x, p.all_y,
                                       dep) if collect_metrics else None),
        backend=backend, telemetry=telemetry, log_every=log_every)
    outs = {k: v.cpu().numpy() for k, v in outs.items()}   # waits
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    rows = []
    for s in range(len(cfgs)):
        curves: dict = {"round": list(range(1, cfg.rounds + 1))}
        for k in ("loss", "accuracy") + METRIC_KEYS:
            curves[k] = ([float(v) for v in outs[k][s]]
                         if collect_metrics else [])
        curves["wall_s"] = wall / len(cfgs)
        curves["iters"] = cfg.rounds * dep.comm_period
        curves["spectral_lambda"] = float(np.atleast_1d(lambdas)[
            s if plan.is_stacked else 0])
        curves["sweep_group_id"] = group_id
        curves["sweep_group_size"] = len(cfgs)
        curves["sweep_group_wall_s"] = wall
        rows.append(curves)
    if telemetry is not None:
        for s, curves in enumerate(rows):
            _recorded(telemetry, curves, s)
    return rows


def run_depositum_grid(cfgs: list[ExperimentConfig],
                       collect_metrics: bool = True, *, backend=None,
                       params0: dict | None = None, telemetry=None,
                       log_every: int = 1, device="cuda") -> list[dict]:
    """Run a grid of experiments through the sweep engine.

    Configs are grouped by static structure (:func:`_static_key`); each
    group is one sweep over its stacked Hyper axis and, since mixing is a
    MixPlan operand, over a stacked dense-W topology axis too.  Returns
    per-config curve dicts in input order, shaped like
    :func:`run_depositum`'s curves, with each point's ``spectral_lambda``
    and its group's id, size and wall time.  ``params0`` replaces every
    group's seeded initial weights.  ``telemetry`` (one static group only:
    the ``config`` tags are a group's) adds each row's recorded streams.
    """
    groups: dict[tuple, list[int]] = {}
    for i, cfg in enumerate(cfgs):
        groups.setdefault(_static_key(cfg), []).append(i)
    if telemetry is not None and len(groups) > 1:
        # config tags are per group; one recorder cannot keep two groups'
        # streams apart
        raise ValueError(
            f"telemetry needs a single static-config group, got "
            f"{len(groups)}; run groups separately with fresh recorders")
    out: list = [None] * len(cfgs)
    for gid, idxs in enumerate(groups.values()):
        rows = _run_sweep_group([cfgs[i] for i in idxs], gid,
                                collect_metrics, backend=backend,
                                params0=params0, telemetry=telemetry,
                                log_every=log_every, device=device)
        for i, row in zip(idxs, rows):
            out[i] = row
    return out


def grid_wall_s(rows: list[dict]) -> float:
    """Total wall time of grid rows (each sweep group counted once)."""
    seen, total = set(), 0.0
    for r in rows:
        gid = r.get("sweep_group_id")
        if gid is None:
            total += r["wall_s"]
        elif gid not in seen:
            seen.add(gid)
            total += r["sweep_group_wall_s"]
    return total


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--fused", default="auto",
                    choices=("auto", "require", "off"))
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = mlp_config(args.rounds, fused=args.fused)
    _, curves = run_depositum(cfg, metrics_every=max(args.rounds // 5, 1),
                              device=args.device)
    for i, r in enumerate(curves["round"]):
        print(f"round {r:3d}  acc={curves['accuracy'][i]:.3f}  "
              f"loss={curves['loss'][i]:.4f}  "
              f"stationarity={curves['stationarity'][i]:.3e}  "
              f"consensus={curves['consensus_x'][i]:.2e}")
    print(f"{args.rounds} rounds in {curves['wall_s']:.2f} s on "
          f"{args.device}: MLP + MCP prox on a ring of 10 clients, no server.")


if __name__ == "__main__":
    main()
