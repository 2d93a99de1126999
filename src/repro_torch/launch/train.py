"""Training launcher (port of ``repro/launch/train.py``): DEPOSITUM over a
zoo architecture on stacked clients, one process, one device.

Example (CPU, reduced config):
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --reduced --device cpu --clients 4 --rounds 20 --t0 4 \\
        --topology ring --prox l1 --lam 1e-5

Without ``--device cpu`` it runs on the card (and raises without one);
every step then runs the two grouped sweep kernels (``fused="auto"``).
Weights are drawn from ``--seed``, tokens from the synthetic per-client
streams; ``--log-every`` sets how often a round's loss is printed.
``--ckpt`` saves the consensus model in the reference's format
(``repro_torch.training.checkpoint``), which ``launch.serve --ckpt``
serves.
"""
from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.configs import get_config
from repro_torch.core import DepositumConfig, plan_spectral_lambda
from repro_torch.data import make_federated_lm_streams
from repro_torch.models import build_model
from repro_torch.training import save_checkpoint
from repro_torch.training.train_loop import (
    FederatedTrainer,
    TrainerConfig,
    lm_batch_iterator,
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-trainable)")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--t0", type=int, default=4, help="communication period T0")
    ap.add_argument("--alpha", type=float, default=0.02)
    ap.add_argument("--beta", type=float, default=1.0)
    ap.add_argument("--gamma", type=float, default=0.8)
    ap.add_argument("--momentum", default="polyak",
                    choices=["polyak", "nesterov", "none"])
    ap.add_argument("--topology", default="ring")
    ap.add_argument("--prox", default="l1",
                    choices=["l1", "mcp", "scad", "l2sq", "zero"])
    ap.add_argument("--lam", type=float, default=1e-5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--log", default="")
    ap.add_argument("--log-every", type=int, default=10,
                    help="rounds between logged losses (and the last)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build(args):
    """(trainer, config, initial state, batch iterator) of ``args``."""
    cfg = get_config(args.arch, reduced=args.reduced)
    model = build_model(cfg, device=args.device)
    prox_kwargs = {"lam": args.lam}
    if args.prox in ("mcp", "scad"):
        prox_kwargs["theta"] = 4.0
    if args.prox == "zero":
        prox_kwargs = {}
    dep = DepositumConfig(
        alpha=args.alpha, beta=args.beta, gamma=args.gamma,
        momentum=args.momentum, comm_period=args.t0,
        prox_name=args.prox, prox_kwargs=prox_kwargs, fused="auto",
    )
    tc = TrainerConfig(n_clients=args.clients, topology=args.topology,
                       depositum=dep, seed=args.seed,
                       log_every=args.log_every)
    trainer = FederatedTrainer(model, tc, device=args.device)
    state = trainer.init_state(args.seed)
    stream = make_federated_lm_streams(cfg.vocab_size, args.clients,
                                       seed=args.seed)
    it = lm_batch_iterator(stream, tc, batch=args.batch, seq_len=args.seq,
                           device=args.device)
    return trainer, cfg, state, it


def main(argv=None):
    """Train; returns (trainer, final state, history)."""
    args = parse_args(argv)
    trainer, _cfg, state, it = build(args)
    lam = float(plan_spectral_lambda(trainer.plan, args.clients))
    print(f"topology {args.topology} on {args.clients} clients: "
          f"spectral lambda = {lam:.4f}")

    t0 = time.time()
    state, history = trainer.run(state, it, args.rounds, donate=True)
    for rec in history:
        print(json.dumps(rec))
    print(f"trained {args.rounds} rounds in {time.time()-t0:.1f}s "
          f"({args.rounds * args.t0} iterations)")

    if args.ckpt:
        save_checkpoint(args.ckpt, trainer.mean_params(state),
                        step=args.rounds)
        print("checkpoint ->", args.ckpt)
    if args.log:
        os.makedirs(os.path.dirname(os.path.abspath(args.log)), exist_ok=True)
        with open(args.log, "w") as f:
            json.dump(history, f, indent=2)
    return trainer, state, history


if __name__ == "__main__":
    main()
