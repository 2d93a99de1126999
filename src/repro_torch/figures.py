"""The paper's figure grids through the sweep engine.

Port of the grids of ``benchmarks/fig3_stepsizes.py`` (step sizes: a
linear model with l1, a 5-point (alpha, beta) grid), ``fig4_momentum.py``
(momentum: MLP + MCP, none / Polyak / Nesterov x gamma, one sweep a
momentum kind), ``fig6_topology.py`` (complete / ring / star / torus as a
stacked dense W), ``fig8_timevarying.py`` (lazy participation p in {0.3,
0.6, 1.0} and Chebyshev k in {1, 2, 3} on a ring, densified to per-round
W and stacked: six schedules) and ``fig_cohort.py`` (n in {8, 32, 128,
512} x p in {0.5, 1.0} Bernoulli cohorts on rings padded to 512 clients,
least squares) and ``fig_comm_frontier.py`` (the accuracy-vs-bytes
frontier: a dense baseline, top-k at rates {0.05, 0.1, 0.25, 0.5} and QSGD
at {2, 4, 8} bits as one mixed-kind sweep over CHOCO-compressed gossip,
least squares on a ring), ``fig5_period.py`` (T0 in {1, 5, 10, 20} at
400 iterations), ``fig7_speedup.py`` (n in {4, 9, 16, 25} clients at
Corollary 1's alpha, gamma and B; each T0 and each n its own static group)
and Table III (``table3_algorithms.py``: DEPOSITUM OPTION I / II against
FedMiD, FedDR and FedADMM on three partitions, the three seeds of a cell
as one S = 3 run), and ``async_throughput.py`` (``--fig async``: the async
learner's virtual round throughput against the synchronous barrier under
three straggler laws, least squares on 8 clients).  Each
``*_run(rounds, sequential, device)`` returns one row a grid point (Table
III: a partition; async: a straggler law) as the reference's ``run`` does;
``sequential=True`` runs every point alone through the one-config round
program instead.

    PYTHONPATH=src python -m repro_torch.figures --fig 6 [--rounds N]
        [--sequential] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.analysis.comm import (
    round_wire_bytes,
    spec_bits_per_coord,
    sweep_round_bytes,
)
from torch.func import functional_call

from repro_torch.core import (
    CohortSampler,
    CompressionSpec,
    DepositumConfig,
    Hyper,
    MixPlan,
    MixSchedule,
    as_stacked_schedule,
    init as dep_init,
    local_then_comm_round,
    make_dense_mixer,
    mixing_matrix,
    as_schedule,
    pad_plan,
    schedule_spectral_lambda,
    stack_hypers,
    stack_schedules,
    sync_virtual_time,
    validate_schedule,
)
from repro_torch.core.fedopt import FedAlgConfig, make_algorithm
from repro_torch.core.mixing import as_dense
from repro_torch.core.staleness import StragglerModel
from repro_torch.data import make_classification
from repro_torch.models.registry import Model
from repro_torch.models.classifier import (
    MODELS,
    client_grad_fn,
    init_params,
    stationarity_grad_fns,
)
from repro_torch.quickstart import (
    ExperimentConfig,
    classifier_metrics,
    run_depositum,
    run_depositum_grid,
)
from repro_torch.training.async_runtime import (
    AsyncConfig,
    AsyncTrainer,
    tabulate_batches,
)
from repro_torch.training.sweep import (
    sweep_run,
    sweep_run_fedalg,
    sweep_run_sequential,
)
from repro_torch.training.train_loop import FederatedTrainer, TrainerConfig


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _grid_curves(cfgs, sequential, device, params0=None):
    if sequential:
        return [run_depositum(c, metrics_every=1, params0=params0,
                              device=device)[1] for c in cfgs]
    return run_depositum_grid(cfgs, params0=params0, device=device)


def _group_fields(c) -> dict:
    return {"wall_s": c["wall_s"],
            "sweep_group_id": c.get("sweep_group_id"),
            "sweep_group_wall_s": c.get("sweep_group_wall_s"),
            "curves": c}


# ---------------------------------------------------------------------------
# Fig. 3: step sizes alpha, beta (linear + l1, ring)
# ---------------------------------------------------------------------------

FIG3_GRID = [(0.05, 0.5), (0.05, 1.0), (0.1, 0.5), (0.1, 1.0), (0.2, 0.5)]


def fig3_configs(rounds: int = 60, fused: str = "auto"):
    return [
        ExperimentConfig(
            model="linear", n_clients=10, topology="ring", rounds=rounds,
            depositum=DepositumConfig(alpha=alpha, beta=beta, gamma=0.5,
                                      comm_period=5, prox_name="l1",
                                      prox_kwargs={"lam": 1e-4},
                                      fused=fused))
        for alpha, beta in FIG3_GRID]


def fig3_run(rounds: int = 60, sequential: bool = False, device="cuda",
             fused: str = "auto"):
    curves = _grid_curves(fig3_configs(rounds, fused), sequential, device)
    return [{"alpha": a, "beta": b, "alpha_beta": a * b,
             "final_loss": c["loss"][-1],
             "final_prox_grad": c["prox_grad_sq"][-1],
             "final_consensus_x": c["consensus_x"][-1],
             "final_grad_est_err": c["grad_est_err"][-1],
             "iters": c["iters"], **_group_fields(c)}
            for (a, b), c in zip(FIG3_GRID, curves)]


# ---------------------------------------------------------------------------
# Fig. 4: momentum gamma, OPTION I / II / none (MLP + MCP, Dirichlet)
# ---------------------------------------------------------------------------

FIG4_SETTINGS = [("none", 0.0)] + [(m, g) for m in ("polyak", "nesterov")
                                   for g in (0.2, 0.5, 0.8)]


def fig4_configs(rounds: int = 50, fused: str = "auto"):
    return [
        ExperimentConfig(
            model="mlp", n_clients=10, topology="ring", theta=1.0,
            n_classes=10, rounds=rounds,
            depositum=DepositumConfig(alpha=0.05, beta=0.5, gamma=gamma,
                                      momentum=momentum, comm_period=10,
                                      prox_name="mcp",
                                      prox_kwargs={"lam": 1e-4,
                                                   "theta": 4.0},
                                      fused=fused))
        for momentum, gamma in FIG4_SETTINGS]


def fig4_run(rounds: int = 50, sequential: bool = False, device="cuda",
             fused: str = "auto"):
    curves = _grid_curves(fig4_configs(rounds, fused), sequential, device)
    return [{"momentum": m, "gamma": g, "final_loss": c["loss"][-1],
             "final_acc": c["accuracy"][-1], **_group_fields(c)}
            for (m, g), c in zip(FIG4_SETTINGS, curves)]


# ---------------------------------------------------------------------------
# Fig. 6: topology (complete / ring / star / torus) as a stacked dense W
# ---------------------------------------------------------------------------

FIG6_TOPOLOGIES = ["complete", "ring", "star", "torus"]


def fig6_configs(rounds: int = 40, fused: str = "auto"):
    return [
        ExperimentConfig(
            model="mlp", n_clients=10, topology=topo, theta=1.0,
            n_classes=10, rounds=rounds,
            depositum=DepositumConfig(alpha=0.05, beta=0.5, gamma=0.5,
                                      comm_period=20, prox_name="mcp",
                                      prox_kwargs={"lam": 1e-4,
                                                   "theta": 4.0},
                                      fused=fused))
        for topo in FIG6_TOPOLOGIES]


def fig6_run(rounds: int = 40, sequential: bool = False, device="cuda",
             fused: str = "auto"):
    curves = _grid_curves(fig6_configs(rounds, fused), sequential, device)
    return [{"topology": t, "lambda": c["spectral_lambda"],
             "final_loss": c["loss"][-1], "final_acc": c["accuracy"][-1],
             "final_consensus_x": c["consensus_x"][-1], **_group_fields(c)}
            for t, c in zip(FIG6_TOPOLOGIES, curves)]


def fig6_check(rows) -> dict:
    by = {r["topology"]: r for r in rows}
    return {
        "complete_best_consensus": by["complete"]["final_consensus_x"]
        <= min(by["ring"]["final_consensus_x"],
               by["star"]["final_consensus_x"]) + 1e-6,
        "lambda_ordering": (by["complete"]["lambda"] < 1e-6
                            and by["torus"]["lambda"] <= by["ring"]["lambda"]
                            + 1e-9 and by["ring"]["lambda"] < 1.0),
        "loss_band": max(r["final_loss"] for r in rows)
        - min(r["final_loss"] for r in rows),
    }


# ---------------------------------------------------------------------------
# Fig. 8: time-varying communication (lazy p x Chebyshev k on a ring)
# ---------------------------------------------------------------------------

FIG8_CLIENTS, FIG8_P, FIG8_K = 10, [0.3, 0.6, 1.0], [1, 2, 3]


@dataclasses.dataclass
class Fig8:
    """The Fig. 8 sweep's operands: the stacked per-round schedule of the
    six points (S, R, n, n), the Hyper and data shared by all."""

    config: DepositumConfig
    names: list
    grid: MixSchedule        # stacked (S, R, n, n)
    hypers: object
    params0: dict
    grad_fn: object
    batches: dict
    metrics_fn: object


def fig8_setup(rounds: int = 30, device="cuda", fused: str = "auto") -> Fig8:
    dev = resolve_device(device)
    dep = DepositumConfig(alpha=0.05, beta=0.5, gamma=0.5, comm_period=5,
                          prox_name="l1", prox_kwargs={"lam": 1e-4},
                          fused=fused)
    ds = make_classification(n_samples=2048, n_features=64, n_classes=5,
                             n_clients=FIG8_CLIENTS, theta=1.0, seed=0)
    model = MODELS["mlp"](64, 5).to(dev)
    xs = torch.from_numpy(np.stack([ds.client_arrays(i)[0]
                                    for i in range(FIG8_CLIENTS)])).to(dev)
    ys = torch.from_numpy(np.stack([ds.client_arrays(i)[1]
                                    for i in range(FIG8_CLIENTS)])).to(dev)
    base = MixPlan.dense(mixing_matrix("ring", FIG8_CLIENTS), device=dev)
    pts = [(f"lazy_p{p}", MixSchedule.lazy(base, p, rounds=rounds, seed=42))
           for p in FIG8_P]
    pts += [(f"cheby_k{k}", MixSchedule.chebyshev(base, k)) for k in FIG8_K]
    grid = stack_schedules([as_stacked_schedule(s, rounds, FIG8_CLIENTS)
                            for _, s in pts])
    rng = np.random.default_rng(7)
    draws = [ds.stacked_batches(rng, 32, dep.comm_period)
             for _ in range(rounds)]
    return Fig8(
        config=dep, names=[n for n, _ in pts], grid=grid, hypers=stack_hypers([dep.hyper()] * len(pts)),
        params0=init_params(model, 0, device=dev),
        grad_fn=client_grad_fn(model),
        batches={"x": torch.from_numpy(np.stack([d[0] for d in draws])),
                 "y": torch.from_numpy(np.stack([d[1] for d in draws]))},
        metrics_fn=classifier_metrics(
            model, stationarity_grad_fns(model, xs, ys), xs.reshape(-1, 64),
            ys.reshape(-1), dep))


def fig8_run(rounds: int = 30, sequential: bool = False, device="cuda",
             fused: str = "auto"):
    f = fig8_setup(rounds, device, fused)
    validate_schedule(f.grid, FIG8_CLIENTS)
    lams = schedule_spectral_lambda(f.grid, FIG8_CLIENTS, rounds=rounds)
    run = sweep_run_sequential if sequential else sweep_run
    t0 = time.perf_counter()
    _final, outs = run(f.params0, f.grad_fn, f.config, f.grid, f.hypers,
                       f.batches, n_clients=FIG8_CLIENTS,
                       metrics_fn=f.metrics_fn)
    outs = {k: v.cpu().numpy() for k, v in outs.items()}
    _sync(device)
    wall = time.perf_counter() - t0
    rows = []
    for s, name in enumerate(f.names):
        curves = {"round": list(range(1, rounds + 1)),
                  **{k: [float(v) for v in outs[k][s]]
                     for k in ("loss", "accuracy", "consensus_x",
                               "stationarity")},
                  "wall_s": wall / len(f.names),
                  "iters": rounds * f.config.comm_period,
                  "sweep_group_id": None if sequential else 0,
                  "sweep_group_size": len(f.names),
                  "sweep_group_wall_s": wall}
        kind, value = name.split("_")
        rows.append({"schedule": name,
                     ("p_active" if kind == "lazy" else "cheby_k"):
                         float(value[1:]) if kind == "lazy"
                         else int(value[1:]),
                     "mean_lambda": float(np.mean(lams[s])),
                     "final_loss": curves["loss"][-1],
                     "final_acc": curves["accuracy"][-1],
                     "final_consensus_x": curves["consensus_x"][-1],
                     **_group_fields(curves)})
    return rows


def fig8_check(rows) -> dict:
    by = {r["schedule"]: r for r in rows}
    return {
        "chebyshev_shrinks_lambda":
            by["cheby_k3"]["mean_lambda"] < by["cheby_k2"]["mean_lambda"]
            < by["cheby_k1"]["mean_lambda"],
        "k1_matches_full_participation_lambda":
            abs(by["cheby_k1"]["mean_lambda"]
                - by["lazy_p1.0"]["mean_lambda"]) < 1e-6,
        "grid_points": len(rows),
    }


# ---------------------------------------------------------------------------
# Cohort grid: n_clients x p_active on one padded client axis
# ---------------------------------------------------------------------------

COHORT_SIZES, COHORT_P, COHORT_N_MAX = [8, 32, 128, 512], [0.5, 1.0], 512
COHORT_D, COHORT_M, COHORT_T0, COHORT_SEED = 32, 16, 5, 42


@dataclasses.dataclass
class Cohort:
    """The cohort sweep's operands: least-squares clients drawn once at
    ``n_max`` (a native size-n problem is the row slice ``[:n]``), and per
    point a padded cohort schedule and its native twin."""

    config: DepositumConfig
    points: list             # (name, n, p, padded schedule, native)
    grid: MixSchedule        # the padded schedules stacked
    A: torch.Tensor          # (n_max, M, D)
    b: torch.Tensor          # (n_max, M)
    n_max: int


def cohort_grad_fn(A: torch.Tensor, b: torch.Tensor):
    """Full-batch least-squares gradients ``A_i^T (A_i w_i - b_i) / M`` of
    the first ``len(A)`` clients; rows past them (padding) get zeros."""
    n = A.shape[0]

    def grad_fn(x, batch):
        w = x["w"]
        r = torch.einsum("nmd,nd->nm", A, w[:n]) - b
        g = torch.einsum("nmd,nm->nd", A, r) / A.shape[1]
        pad = w.shape[0] - n
        if pad:
            g = torch.cat([g, g.new_zeros((pad,) + g.shape[1:])])
        return {"w": g}, {}

    return grad_fn


def cohort_metrics(state, hyper, operand) -> dict:
    """Consensus and mean norm over the point's eligible rows."""
    w = operand.sampler.eligible()
    w = w / torch.sum(w)
    x = state.x["w"]
    xbar = torch.einsum("i,id->d", w, x)
    return {"consensus_x": torch.einsum("i,id->", w, (x - xbar[None]) ** 2),
            "xbar_norm": torch.sum(xbar ** 2)}


def cohort_setup(device="cuda", fused: str = "auto", *,
                 sizes=COHORT_SIZES, p_active=COHORT_P,
                 n_max: int = COHORT_N_MAX, seed: int = 0) -> Cohort:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    D, M = COHORT_D, COHORT_M
    A = rng.standard_normal((n_max, M, D)).astype(np.float32)
    w_true = rng.standard_normal(D).astype(np.float32)
    b = np.einsum("nmd,d->nm", A, w_true)
    dep = DepositumConfig(alpha=0.05, beta=0.5, gamma=0.5,
                          comm_period=COHORT_T0, prox_name="l1",
                          prox_kwargs={"lam": 1e-4}, fused=fused)
    pts = []
    for n in sizes:
        ring = MixPlan.from_topology("ring", n, device=dev)
        for p in p_active:
            pts.append((f"n{n}_p{p}", n, p,
                        MixSchedule.cohort(pad_plan(ring, n_max),
                                           CohortSampler.bernoulli(
                                               p, n_max, seed=COHORT_SEED,
                                               n_eff=n, device=dev)),
                        MixSchedule.cohort(ring, CohortSampler.bernoulli(
                            p, n, seed=COHORT_SEED, device=dev))))
    return Cohort(config=dep, points=pts,
                  grid=stack_schedules([pt[3] for pt in pts]),
                  A=torch.from_numpy(A).to(dev),
                  b=torch.from_numpy(b).to(dev), n_max=n_max)


def cohort_run(rounds: int = 30, sequential: bool = False, device="cuda",
               fused: str = "auto", **grid):
    """The grid as one padded sweep (``sequential``: one native-size run
    a point).  Each padded point is held against its native run
    (``native_rel_err``, the reference's acceptance)."""
    c = cohort_setup(device, fused, **grid)
    params0 = {"w": torch.zeros(COHORT_D, device=c.A.device)}
    batches = torch.zeros((rounds, COHORT_T0, 1), device=c.A.device)
    hyper = c.config.hyper()

    def native(n, sched):
        return sweep_run_sequential(
            params0, cohort_grad_fn(c.A[:n], c.b[:n]), c.config, sched,
            hyper, batches, n_clients=n, metrics_fn=cohort_metrics)

    t0 = time.perf_counter()
    if sequential:
        runs = [native(n, nat) for _, n, _, _, nat in c.points]
        outs = {k: torch.cat([o[k] for _, o in runs]) for k in runs[0][1]}
        finals = None
    else:
        validate_schedule(c.grid, c.n_max)
        finals, outs = sweep_run(
            params0, cohort_grad_fn(c.A, c.b), c.config, c.grid,
            stack_hypers([hyper] * len(c.points)), batches,
            n_clients=c.n_max, metrics_fn=cohort_metrics)
    outs = {k: v.cpu().numpy() for k, v in outs.items()}
    _sync(device)
    wall = time.perf_counter() - t0
    rows = []
    for s, (name, n, p, _padded, nat) in enumerate(c.points):
        if finals is not None:
            ref = native(n, nat)[0].x["w"][0]
            got = finals.x["w"][s, :n]
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max()) or 1.0
        else:
            err, scale = 0.0, 1.0
        eff = float(np.mean([float(nat.sampler.mask_at(r).sum())
                             for r in range(rounds)]))
        curves = {"round": list(range(1, rounds + 1)),
                  "consensus_x": [float(v) for v in outs["consensus_x"][s]],
                  "xbar_norm": [float(v) for v in outs["xbar_norm"][s]],
                  "wall_s": wall / len(c.points),
                  "iters": rounds * COHORT_T0,
                  "sweep_group_id": None if sequential else 0,
                  "sweep_group_size": len(c.points),
                  "sweep_group_wall_s": wall}
        rows.append({"name": name, "n_clients": n, "p_active": p,
                     "n_max": c.n_max, "eff_clients_per_round": eff,
                     "native_rel_err": err / scale,
                     "final_consensus_x": curves["consensus_x"][-1],
                     **_group_fields(curves)})
    return rows


def cohort_check(rows) -> dict:
    full = [r for r in rows if r["p_active"] == 1.0]
    part = [r for r in rows if r["p_active"] < 1.0]
    return {
        "padded_matches_native":
            max(r["native_rel_err"] for r in rows) < 1e-4,
        "full_participation_exact":
            all(r["eff_clients_per_round"] == r["n_clients"] for r in full),
        "bernoulli_cohort_size_tracks_p":
            all(abs(r["eff_clients_per_round"]
                    - r["p_active"] * r["n_clients"])
                < 10 * np.sqrt(r["n_clients"] * 0.25) + 1.0 for r in part),
    }


# ---------------------------------------------------------------------------
# Accuracy-vs-bytes frontier: the compressor as a sweep axis
# ---------------------------------------------------------------------------

COMM_N, COMM_D, COMM_M, COMM_T0 = 8, 64, 16, 5
COMM_TOPK_RATES, COMM_QSGD_BITS, COMM_EF_STEP = [0.05, 0.1, 0.25, 0.5], \
    [2, 4, 8], 0.3


def comm_config(fused: str = "auto") -> DepositumConfig:
    return DepositumConfig(alpha=0.05, beta=0.5, gamma=0.5,
                           comm_period=COMM_T0, prox_name="l1",
                           prox_kwargs={"lam": 1e-5}, fused=fused)


def comm_data(seed: int = 7) -> tuple[np.ndarray, np.ndarray]:
    """Least squares ``A (N, M, D)``, ``b = A w_true`` from a numpy seed
    (the reference draws them with threefry)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((COMM_N, COMM_M, COMM_D)).astype(np.float32)
    w_true = rng.standard_normal(COMM_D).astype(np.float32)
    return A, np.einsum("nmd,d->nm", A, w_true)


def comm_points(device="cuda", rates=COMM_TOPK_RATES, bits=COMM_QSGD_BITS,
                uniforms=None) -> list:
    """(name, kind, level, native one-kind schedule) a grid point, on a
    ring of ``COMM_N``; ``uniforms`` replaces every spec's hashed draws."""
    dev = resolve_device(device)
    base = as_schedule(MixPlan.from_topology("ring", COMM_N, device=dev))
    hook = lambda spec: dataclasses.replace(spec, uniforms=uniforms)
    pts = [("dense", "none", 1.0, base.with_compression(
        hook(CompressionSpec.none(device=dev))))]
    pts += [(f"topk_{r}", "topk", r, base.with_compression(hook(
        CompressionSpec.topk(r, ef_step=COMM_EF_STEP, device=dev))))
        for r in rates]
    pts += [(f"qsgd_{b}b", "qsgd", b, base.with_compression(hook(
        CompressionSpec.qsgd(b, ef_step=COMM_EF_STEP, device=dev))))
        for b in bits]
    return pts


def comm_grad_fn(A: torch.Tensor, b: torch.Tensor):
    """Full-batch least-squares gradients ``A_i^T (A_i w_i - b_i) / M``."""
    def grad_fn(x, batch):
        r = torch.einsum("nmd,nd->nm", A, x["w"]) - b
        return {"w": torch.einsum("nmd,nm->nd", A, r) / A.shape[1]}, {}

    return grad_fn


def comm_metrics(A: torch.Tensor, b: torch.Tensor):
    """Loss of the client mean and consensus of x (the reference's)."""
    def metrics(state, hyper, operand):
        x = state.x["w"]
        xbar = torch.mean(x, dim=0)
        r = torch.einsum("nmd,d->nm", A, xbar) - b
        return {"loss": torch.mean(r ** 2),
                "consensus_x": torch.mean((x - xbar[None]) ** 2)}

    return metrics


@dataclasses.dataclass
class Comm:
    """The frontier's operands: the config, the points (name, kind, level,
    native one-kind schedule), their stack (the ``mixed`` form) and the
    least-squares data on the device."""

    config: DepositumConfig
    points: list
    grid: MixSchedule
    A: torch.Tensor          # (N, M, D)
    b: torch.Tensor          # (N, M)

    def operands(self, rounds: int) -> tuple:
        """(params0, grad_fn, batches, metrics_fn) of a ``rounds`` run."""
        dev = self.A.device
        return ({"w": torch.zeros(COMM_D, device=dev)},
                comm_grad_fn(self.A, self.b),
                torch.zeros((rounds, COMM_T0, 1), device=dev),
                comm_metrics(self.A, self.b))


def comm_setup(device="cuda", fused: str = "auto", *, rates=COMM_TOPK_RATES,
               bits=COMM_QSGD_BITS, data=None, uniforms=None) -> Comm:
    """``data`` replaces :func:`comm_data`'s ``(A, b)``; ``uniforms`` as in
    :func:`comm_points`."""
    dev = resolve_device(device)
    A, b = comm_data() if data is None else data
    A, b = (torch.as_tensor(np.array(v, np.float32), device=dev)
            for v in (A, b))
    pts = comm_points(dev, rates, bits, uniforms)
    return Comm(config=comm_config(fused), points=pts,
                grid=stack_schedules([sched for *_, sched in pts]), A=A, b=b)


def comm_run(rounds: int = 30, sequential: bool = False, device="cuda",
             fused: str = "auto", **setup):
    """The frontier as one sweep (every kind in the ``mixed`` form), or
    with ``sequential`` one native-kind run a point (``setup`` as in
    :func:`comm_setup`).  Bytes are priced from the native schedules; each
    row also carries the stacked grid's bytes for the check."""
    c = comm_setup(device, fused, **setup)
    params0, grad_fn, batches, metrics_fn = c.operands(rounds)
    hyper = c.config.hyper()
    t0 = time.perf_counter()
    if sequential:
        runs = [sweep_run_sequential(params0, grad_fn, c.config, sched,
                                     hyper, batches, n_clients=COMM_N,
                                     metrics_fn=metrics_fn)[1]
                for *_, sched in c.points]
        outs = {k: torch.cat([o[k] for o in runs]) for k in runs[0]}
    else:
        validate_schedule(c.grid, COMM_N)
        _final, outs = sweep_run(params0, grad_fn, c.config, c.grid,
                                 stack_hypers([hyper] * len(c.points)),
                                 batches, n_clients=COMM_N,
                                 metrics_fn=metrics_fn)
    outs = {k: v.cpu().numpy() for k, v in outs.items()}
    _sync(c.A.device)
    wall = time.perf_counter() - t0
    stacked = sweep_round_bytes(c.grid, d=COMM_D, n=COMM_N)
    rows = []
    for s, (name, kind, lvl, sched) in enumerate(c.points):
        bytes_rd = float(round_wire_bytes(sched, d=COMM_D, n=COMM_N))
        curves = {"round": list(range(1, rounds + 1)),
                  "loss": [float(v) for v in outs["loss"][s]],
                  "consensus_x": [float(v) for v in outs["consensus_x"][s]],
                  "wall_s": wall / len(c.points), "iters": rounds * COMM_T0,
                  "sweep_group_id": None if sequential else 0,
                  "sweep_group_size": len(c.points),
                  "sweep_group_wall_s": wall}
        rows.append({
            "name": name, "kind": kind, "level": lvl,
            "bytes_per_round": bytes_rd,
            "stacked_bytes_per_round": float(stacked[s]),
            "bits_per_coord": float(spec_bits_per_coord(sched.compress,
                                                        COMM_D)),
            "total_mb": bytes_rd * rounds / 1e6,
            "final_loss": curves["loss"][-1],
            "first_loss": curves["loss"][0],
            "final_consensus_x": curves["consensus_x"][-1],
            **_group_fields(curves)})
    return rows


def comm_check(rows) -> dict:
    """The reference's ``fig_comm_frontier.check``."""
    dense = next(r for r in rows if r["kind"] == "none")
    topk = sorted((r for r in rows if r["kind"] == "topk"),
                  key=lambda r: r["level"])
    qsgd = [r for r in rows if r["kind"] == "qsgd"]
    stacked = np.asarray([r["stacked_bytes_per_round"] for r in rows])
    native = np.asarray([r["bytes_per_round"] for r in rows])
    return {
        "single_program":
            len({r["sweep_group_id"] for r in rows}) == 1
            if rows[0]["sweep_group_id"] is not None else False,
        "kinds_swept": len({r["kind"] for r in rows}),
        "compressed_points": len(topk) + len(qsgd),
        "stacked_accounting_matches_native":
            bool(np.max(np.abs(stacked - native)) < 1e-6 * max(native)),
        "topk_bytes_monotone":
            all(a["bytes_per_round"] < b["bytes_per_round"]
                for a, b in zip(topk, topk[1:])),
        "topk_bytes_at_most_dense":
            all(r["bytes_per_round"] <= dense["bytes_per_round"]
                for r in topk),
        "qsgd_bytes_below_dense":
            all(r["bytes_per_round"] < dense["bytes_per_round"]
                for r in qsgd),
        "all_points_converge":
            all(r["final_loss"] < r["first_loss"] for r in rows),
        "dense_converges_fast":
            dense["final_loss"] < 0.2 * dense["first_loss"],
        "grid_points": len(rows),
    }


# ---------------------------------------------------------------------------
# Fig. 5: communication period T0 at a fixed iteration count
# ---------------------------------------------------------------------------

FIG5_PERIODS, FIG5_ITERS = [1, 5, 10, 20], 400


def fig5_configs(iters: int = FIG5_ITERS, fused: str = "auto"):
    """``fig5_period.py``: the same ``iters`` iterations, T0 in
    ``FIG5_PERIODS`` (each period its own static group: T0 and the round
    count change the round program)."""
    return [
        ExperimentConfig(
            model="mlp", n_clients=10, topology="ring", theta=1.0,
            n_classes=10, rounds=iters // T0,
            depositum=DepositumConfig(alpha=0.05, beta=0.5, gamma=0.5,
                                      comm_period=T0, prox_name="mcp",
                                      prox_kwargs={"lam": 1e-4,
                                                   "theta": 4.0},
                                      fused=fused))
        for T0 in FIG5_PERIODS]


def fig5_run(iters: int = FIG5_ITERS, sequential: bool = False,
             device="cuda", fused: str = "auto", *,
             params0: dict | None = None):
    cfgs = fig5_configs(iters, fused)
    curves = _grid_curves(cfgs, sequential, device, params0)
    return [{"T0": T0, "communications": iters // T0,
             "final_loss": c["loss"][-1], "final_acc": c["accuracy"][-1],
             "final_consensus_x": c["consensus_x"][-1], **_group_fields(c)}
            for T0, c in zip(FIG5_PERIODS, curves)]


def fig5_check(rows) -> dict:
    """Similar loss at the same iteration count; consensus error rises
    with T0 (the reference's ``check``)."""
    losses = [r["final_loss"] for r in rows]
    cons = [r["final_consensus_x"] for r in rows]
    return {
        "loss_spread": max(losses) - min(losses),
        "similar_loss": max(losses) - min(losses) < 0.5,
        "consensus_grows_with_T0": cons[-1] >= cons[0],
        "comm_reduction": rows[0]["communications"]
        / rows[-1]["communications"],
    }


# ---------------------------------------------------------------------------
# Fig. 7 / Corollary 1: linear speedup in the number of clients
# ---------------------------------------------------------------------------

FIG7_CLIENTS, FIG7_ITERS, FIG7_T0 = [4, 9, 16, 25], 400, 10


def corollary1_params(n: int, T: int = FIG7_ITERS, L: float = 5.0):
    """Corollary 1's alpha ~ sqrt(n), 1 - gamma ~ sqrt(n), B = sqrt(n)."""
    alpha = math.sqrt(n) / (24 * L * math.sqrt(T + 1))
    gamma = 1.0 - math.sqrt(n) / math.sqrt(T + 1)
    B = max(int(round(math.sqrt(n))), 1)
    return alpha, gamma, B


def fig7_configs(iters: int = FIG7_ITERS, fused: str = "auto"):
    """``fig7_speedup.py``: n clients at Corollary 1's hyperparameters,
    alpha scaled x 40 (keeping its sqrt(n) ratio), batch 8 B; each n its
    own static group."""
    out = []
    for n in FIG7_CLIENTS:
        alpha, gamma, B = corollary1_params(n, iters)
        out.append(ExperimentConfig(
            model="mlp", n_clients=n, topology="ring", theta=1.0,
            n_classes=10, rounds=iters // FIG7_T0, batch=8 * B,
            depositum=DepositumConfig(alpha=alpha * 40, beta=1.0,
                                      gamma=gamma, comm_period=FIG7_T0,
                                      prox_name="mcp",
                                      prox_kwargs={"lam": 1e-4,
                                                   "theta": 4.0},
                                      fused=fused)))
    return out


def fig7_run(iters: int = FIG7_ITERS, sequential: bool = False,
             device="cuda", fused: str = "auto", *,
             params0: dict | None = None):
    cfgs = fig7_configs(iters, fused)
    curves = _grid_curves(cfgs, sequential, device, params0)
    return [{"n_clients": cfg.n_clients,
             "alpha": round(cfg.depositum.alpha, 5),
             "gamma": round(cfg.depositum.gamma, 4), "batch": cfg.batch,
             "final_loss": c["loss"][-1], "final_acc": c["accuracy"][-1],
             "final_stationarity": c["stationarity"][-1],
             **_group_fields(c)}
            for cfg, c in zip(cfgs, curves)]


def fig7_check(rows) -> dict:
    """More clients reach a lower (or equal) loss after T iterations."""
    losses = [r["final_loss"] for r in rows]
    return {"monotone_trend": losses[-1] <= losses[0] + 0.05,
            "loss_n4": losses[0], "loss_n25": losses[-1]}


# ---------------------------------------------------------------------------
# Table III: DEPOSITUM (OPTION I / II) against FedMiD / FedDR / FedADMM
# ---------------------------------------------------------------------------

T3_PARTITIONS = {"IID": np.inf, "Dir(1)": 1.0, "Dir(0.1)": 0.1}
T3_ALGS = ["depositum-I", "depositum-II", "fedmid", "feddr", "fedadmm"]
T3_CLIENTS, T3_ROUNDS, T3_T0, T3_SEEDS = 10, 30, 5, (0, 1, 2)
T3_PROX = ("scad", {"lam": 1e-4, "theta": 4.0})
T3_FEATURES, T3_CLASSES, T3_SAMPLES, T3_BATCH = 64, 10, 4096, 32


@dataclasses.dataclass
class Table3Problem:
    """One seed's problem: its data (test split: the last 25%), initial
    weights and every round's minibatches, on the device."""

    ds: object
    params0: dict
    bx: torch.Tensor         # (rounds, T0, C, batch, d)
    by: torch.Tensor


def table3_problem(theta: float, seed: int, rounds: int = T3_ROUNDS,
                   device="cuda", params0=None) -> Table3Problem:
    """``table3_algorithms._seed_problem``: the seed's dataset, weights
    (``params0(seed)`` when given) and minibatches drawn from
    ``default_rng(seed + 13)``, one T0 block a round."""
    dev = resolve_device(device)
    ds = make_classification(n_samples=T3_SAMPLES, n_features=T3_FEATURES,
                             n_classes=T3_CLASSES, n_clients=T3_CLIENTS,
                             theta=theta, seed=seed)
    model = MODELS["mlp"](T3_FEATURES, T3_CLASSES)
    p0 = (init_params(model, seed, device=dev) if params0 is None
          else {k: v.to(dev) for k, v in params0(seed).items()})
    rng = np.random.default_rng(seed + 13)
    draws = [ds.stacked_batches(rng, T3_BATCH, T3_T0) for _ in range(rounds)]
    return Table3Problem(
        ds=ds, params0=p0,
        bx=torch.from_numpy(np.stack([d[0] for d in draws])).to(dev),
        by=torch.from_numpy(np.stack([d[1] for d in draws])).to(dev))


def table3_dep_config(alg: str, fused: str = "auto") -> DepositumConfig:
    """OPTION I (Polyak) takes ``fused``; OPTION II (Nesterov) runs the
    unfused step: the sweep kernels cover Polyak momentum only, in the
    reference as here."""
    prox_name, prox_kwargs = T3_PROX
    polyak = alg.endswith("-I")
    return DepositumConfig(alpha=0.1, beta=1.0, gamma=0.5,
                           momentum="polyak" if polyak else "nesterov",
                           comm_period=T3_T0, prox_name=prox_name,
                           prox_kwargs=prox_kwargs,
                           fused=fused if polyak else "off")


def table3_algorithm(alg: str):
    """A baseline as the table runs it: eta 0.5 on the complete graph."""
    prox_name, prox_kwargs = T3_PROX
    return make_algorithm(alg, FedAlgConfig(
        alpha=0.1, local_steps=T3_T0, prox_name=prox_name,
        prox_kwargs=prox_kwargs, eta=0.5,
        W=mixing_matrix("complete", T3_CLIENTS)))


def _t3_hyper() -> Hyper:
    _, kw = T3_PROX
    return Hyper.create(alpha=0.1, lam=kw["lam"], theta=kw["theta"])


def _test_accuracy(model, x: dict, ds) -> float:
    """The client mean's accuracy on the held-out last 25% of samples."""
    dev = next(iter(x.values())).device
    pbar = {k: torch.mean(v, 0) for k, v in x.items()}
    cut = int(len(ds.y) * 0.75)
    logits = functional_call(model, pbar,
                             (torch.from_numpy(ds.x[cut:]).to(dev),))
    y = torch.from_numpy(ds.y[cut:]).to(dev)
    return float(torch.mean((torch.argmax(logits, -1) == y).to(
        torch.float32)))


def table3_cell(alg: str, theta: float, rounds: int = T3_ROUNDS,
                sequential: bool = False, device="cuda",
                fused: str = "auto", params0=None) -> dict:
    """One (algorithm, partition) cell over ``T3_SEEDS``.

    Batched (the default): the seeds (datasets, weights, minibatch
    streams) stacked as S = 3 on the sweep axis (``params_axis=0``,
    ``batch_axis=0``), one ``sweep_run`` (DEPOSITUM) or
    ``sweep_run_fedalg`` (baselines).  ``sequential``: one run a seed
    through the one-config round.  Returns ``{"accs": [...], "wall_s":
    ..., "x": final x (S, C, ...)}``.
    """
    probs = [table3_problem(theta, s, rounds, device, params0)
             for s in T3_SEEDS]
    dev = probs[0].bx.device
    model = MODELS["mlp"](T3_FEATURES, T3_CLASSES).to(dev)
    grad_fn = client_grad_fn(model)
    dep = alg.startswith("depositum")
    t0 = time.perf_counter()
    if sequential:
        xs = []
        for pr in probs:
            if dep:
                state = dep_init(pr.params0, T3_CLIENTS, device=dev)
                mixer = make_dense_mixer(mixing_matrix("complete",
                                                       T3_CLIENTS),
                                         device=dev)
                cfg = table3_dep_config(alg, fused)
                for r in range(rounds):
                    state, _ = local_then_comm_round(
                        state, {"x": pr.bx[r], "y": pr.by[r]}, grad_fn, cfg,
                        mixer)
            else:
                a = table3_algorithm(alg)
                state = a.init(pr.params0, T3_CLIENTS, device=dev)
                for r in range(rounds):
                    state, _ = a.round(state, {"x": pr.bx[r], "y": pr.by[r]},
                                       grad_fn)
            xs.append(state.x)
        x = {k: torch.stack([xi[k] for xi in xs]) for k in xs[0]}
    else:
        params0_s = {k: torch.stack([pr.params0[k] for pr in probs])
                     for k in probs[0].params0}
        batches = {"x": torch.stack([pr.bx for pr in probs]),
                   "y": torch.stack([pr.by for pr in probs])}
        kw = dict(n_clients=T3_CLIENTS, params_axis=0, batch_axis=0)
        if dep:
            cfg = table3_dep_config(alg, fused)
            final, _ = sweep_run(
                params0_s, grad_fn, cfg,
                MixPlan.from_topology("complete", T3_CLIENTS, device=dev),
                stack_hypers([cfg.hyper()] * len(T3_SEEDS)), batches, **kw)
        else:
            final, _ = sweep_run_fedalg(
                table3_algorithm(alg), params0_s, grad_fn,
                stack_hypers([_t3_hyper()] * len(T3_SEEDS)), batches, **kw)
        x = final.x
    _sync(dev)
    wall = time.perf_counter() - t0
    accs = [_test_accuracy(model, {k: v[i] for k, v in x.items()}, pr.ds)
            for i, pr in enumerate(probs)]
    return {"accs": accs, "wall_s": wall, "x": x}


def table3_run(rounds: int = T3_ROUNDS, sequential: bool = False,
               device="cuda", fused: str = "auto", *, params0=None):
    """One row a partition: mean ± std of the seeds' test accuracy a
    column, as ``table3_algorithms.run``, plus each cell's wall time
    (``_<alg>_wall_s``).  ``params0(seed)`` replaces the seeded weights."""
    rows = []
    for part, theta in T3_PARTITIONS.items():
        row = {"partition": part}
        for alg in T3_ALGS:
            cell = table3_cell(alg, theta, rounds, sequential, device, fused,
                               params0)
            accs = cell["accs"]
            row[alg] = f"{np.mean(accs):.4f}±{np.std(accs):.4f}"
            row[f"_{alg}_mean"] = float(np.mean(accs))
            row[f"_{alg}_wall_s"] = cell["wall_s"]
        rows.append(row)
    return rows


def table3_check(rows) -> dict:
    """Paper claim: DEPOSITUM best in its row (>= max(baselines) - 0.02)."""
    ok = True
    for row in rows:
        dep = max(row["_depositum-I_mean"], row["_depositum-II_mean"])
        base = max(row[f"_{a}_mean"] for a in ("fedmid", "feddr", "fedadmm"))
        ok = ok and (dep >= base - 0.02)
    return {"depositum_best_or_tied": ok}


# ---------------------------------------------------------------------------
# Async round throughput (benchmarks/async_throughput.py)
# ---------------------------------------------------------------------------

# the reference's full problem: least squares, 8 clients on a ring, d 512,
# batch 8, T0 2, l1 1e-4, alpha 0.05, 24 learner rounds at tau 2
ASYNC_N, ASYNC_D, ASYNC_BATCH, ASYNC_T0 = 8, 512, 8, 2
ASYNC_ROUNDS, ASYNC_TAU = 24, 2
ASYNC_HEADLINE = 1.3        # exponential round-throughput ratio, at least


def _ls_loss(params, batch):
    e = batch["x"] @ params["w"] - batch["y"]
    return torch.mean(e * e), {}


def async_problem(rounds: int = ASYNC_ROUNDS, device="cuda",
                  fused: str = "auto"):
    """``async_throughput.py::_problem``: (model, trainer config, per-round
    batches on ``device``), the batches drawn as the reference draws them
    (so a cut run's rounds are the full run's first ones)."""
    dev = resolve_device(device)
    n, d, T0 = ASYNC_N, ASYNC_D, ASYNC_T0
    model = Model(cfg=None, init=lambda seed: ({"w": torch.zeros(d)}, None),
                  forward_train=None, loss=_ls_loss, forward_decode=None,
                  init_decode_cache=None)
    dep = DepositumConfig(alpha=0.05, comm_period=T0, prox_name="l1",
                          prox_kwargs={"lam": 1e-4}, fused=fused)
    cfg = TrainerConfig(n_clients=n, topology="ring", depositum=dep,
                        log_every=max(1, rounds // 2))
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(rounds):
        x = rng.normal(size=(T0, n, ASYNC_BATCH, d)).astype(np.float32)
        y = rng.normal(size=(T0, n, ASYNC_BATCH)).astype(np.float32)
        batches.append({"x": torch.from_numpy(x).to(dev),
                        "y": torch.from_numpy(y).to(dev)})
    return model, cfg, batches


def async_distributions(n: int = ASYNC_N) -> dict:
    """``async_throughput.py::_distributions``: the straggler laws, one
    mean delay."""
    mean = 1.0
    return {
        "deterministic": StragglerModel.deterministic(
            [mean * (i + 1) / ((n + 1) / 2) for i in range(n)]),
        "exponential": StragglerModel.exponential(mean, n, seed=1),
        "heavytail": StragglerModel.heavytail(mean, n, seed=1, shape=2.0),
    }


def async_run(rounds: int = ASYNC_ROUNDS, sequential: bool = False,
              device="cuda", fused: str = "auto"):
    """One row a straggler law: the async learner's and the synchronous
    barrier's virtual times on the same draws, their round-throughput
    ratio, applies and rejects (and the replay log, ``events``).  The
    ``zero`` row instead holds tau 0 with zero delay against the
    synchronous ``FederatedTrainer`` on the same batches: every tree
    ``torch.equal``."""
    if sequential:
        raise ValueError("--fig async has no sequential form")
    model, cfg, batches = async_problem(rounds, device, fused)
    n = cfg.n_clients

    def run_async(sm, tau):
        tr = AsyncTrainer(model, cfg, straggler=sm,
                          async_cfg=AsyncConfig(tau=tau), device=device)
        t0 = time.perf_counter()
        state, _ = tr.run(tr.init_state(0),
                          tabulate_batches(iter(batches), rounds), rounds)
        _sync(device)
        return tr, state, time.perf_counter() - t0

    plan = as_dense(MixPlan.from_topology(cfg.topology, n, device=device), n)
    sync = FederatedTrainer(model, cfg, schedule=MixSchedule.constant(plan),
                            device=device)
    s_sync, _ = sync.run(sync.init_state(0), iter(batches), rounds)
    tr0, s_async, wall = run_async(StragglerModel.zero(n), 0)
    equal = s_sync.t == s_async.t and all(
        torch.equal(a[k], b[k]) for f in ("x", "y", "nu", "mu", "g")
        for a, b in [(getattr(s_sync, f), getattr(s_async, f))] for k in a)
    rows = [{"distribution": "zero", "tau": 0, "sync_equal": equal,
             "async_virtual_time": tr0.virtual_time,
             "applies": sum(e["type"] == "apply" for e in tr0.events),
             "wall_s": wall, "events": tr0.events}]
    for name, sm in async_distributions(n).items():
        tr, _state, wall = run_async(sm, ASYNC_TAU)
        t_sync = sync_virtual_time(sm, rounds)
        rows.append({
            "distribution": name, "tau": ASYNC_TAU,
            "async_virtual_time": tr.virtual_time,
            "sync_virtual_time": t_sync,
            "round_throughput_ratio": t_sync / max(tr.virtual_time, 1e-9),
            "applies": sum(e["type"] == "apply" for e in tr.events),
            "rejects": sum(e["type"] == "reject" for e in tr.events),
            "wall_s": wall, "events": tr.events})
    return rows


def async_check(rows) -> dict:
    """The keystone holds and the exponential ratio reaches the
    reference's retained headline."""
    by = {r["distribution"]: r for r in rows}
    ratio = by["exponential"]["round_throughput_ratio"]
    return {"zero_sync_equal": by["zero"]["sync_equal"],
            "exponential_ratio": ratio,
            "headline_met": ratio >= ASYNC_HEADLINE}


FIGURES = {"3": (fig3_run, None, 60), "4": (fig4_run, None, 50),
           "5": (fig5_run, fig5_check, FIG5_ITERS),
           "6": (fig6_run, fig6_check, 40),
           "7": (fig7_run, fig7_check, FIG7_ITERS),
           "8": (fig8_run, fig8_check, 30),
           "cohort": (cohort_run, cohort_check, 30),
           "comm": (comm_run, comm_check, 30),
           "table3": (table3_run, table3_check, T3_ROUNDS),
           "async": (async_run, async_check, ASYNC_ROUNDS)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fig", required=True, choices=sorted(FIGURES))
    ap.add_argument("--rounds", type=int, default=None,
                    help="rounds (Figs. 5 and 7: iterations)")
    ap.add_argument("--sequential", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fused", default="auto",
                    choices=("auto", "require", "off"))
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run, check, rounds = FIGURES[args.fig]
    rows = run(args.rounds or rounds, args.sequential, args.device,
               args.fused)
    for r in rows:
        print(json.dumps({k: v for k, v in r.items()
                          if k not in ("curves", "events")}))
    if check is not None:
        print(json.dumps({"check": check(rows)}))


if __name__ == "__main__":
    main()
