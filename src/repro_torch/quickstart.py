"""Quickstart: DEPOSITUM rounds of the paper's MLP on a 10-client ring.

Port of ``examples/quickstart.py`` and of ``run_depositum`` in
``benchmarks/common.py`` (without telemetry).  The default configuration
is the Polyak point of the paper's Fig. 4 (``benchmarks/fig4_momentum.py``):
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
    init,
    local_then_comm_round,
    make_dense_mixer,
    mixing_matrix,
    spectral_lambda,
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
            device="cuda") -> Prepared:
    """Data, model, initial state, mixer and every round's minibatches.

    ``params0`` (name -> tensor) replaces the seeded initial weights.  The
    minibatches are drawn up front from the reference's rng stream
    (``seed + 7``) and placed on the device, so a round loop copies nothing
    from the host.
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
    return Prepared(
        model=model, state=init(params0, cfg.n_clients, device=dev),
        grad_fn=client_grad_fn(model),
        grad_fns=stationarity_grad_fns(model, xs_full, ys_full),
        mixer=make_dense_mixer(W, device=dev), W=W,
        bx=torch.from_numpy(np.stack([d[0] for d in draws])).to(dev),
        by=torch.from_numpy(np.stack([d[1] for d in draws])).to(dev),
        all_x=xs_full.reshape(-1, cfg.n_features), all_y=ys_full.reshape(-1))


def run_depositum(cfg: ExperimentConfig, *, collect_metrics: bool = True,
                  metrics_every: int | None = None, params0: dict | None = None,
                  device="cuda"):
    """Run ``cfg.rounds`` DEPOSITUM rounds on ``device``.

    Returns ``(final_state, curves)``; ``curves`` holds per-round loss,
    accuracy and the stationarity terms every ``metrics_every`` rounds (and
    at the last), plus ``wall_s`` (the round loop, metrics included),
    ``iters`` and ``spectral_lambda``.  ``params0`` as in :func:`prepare`.
    """
    p = prepare(cfg, params0=params0, device=device)
    dep, state = cfg.depositum, p.state
    curves: dict[str, list] = {k: [] for k in
                               ("round", "loss", "accuracy") + METRIC_KEYS}
    every = metrics_every if metrics_every else max(cfg.rounds // 20, 1)
    t0 = time.perf_counter()
    for r in range(cfg.rounds):
        state, _ = local_then_comm_round(state, p.batches(r), p.grad_fn, dep,
                                         p.mixer)
        if collect_metrics and (r % every == 0 or r == cfg.rounds - 1):
            m = stationarity_metrics(state, p.grad_fns, dep)
            pbar = {k: torch.mean(v, 0) for k, v in state.x.items()}
            logits = functional_call(p.model, pbar, (p.all_x,))
            curves["round"].append(r + 1)
            curves["loss"].append(float(ce_loss(
                p.model, pbar, {"x": p.all_x, "y": p.all_y})))
            curves["accuracy"].append(float(torch.mean(
                (torch.argmax(logits, -1) == p.all_y).to(torch.float32))))
            for k in METRIC_KEYS:
                curves[k].append(float(m[k]))
    if p.all_x.device.type == "cuda":
        torch.cuda.synchronize(p.all_x.device)
    curves["wall_s"] = time.perf_counter() - t0
    curves["iters"] = cfg.rounds * dep.comm_period
    curves["spectral_lambda"] = float(spectral_lambda(p.W))
    return state, curves


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
