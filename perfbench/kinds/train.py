"""Training cells: full-width DEPOSITUM on stacked clients through the
program's own trainer (``FederatedTrainer.run``, the launcher's path with
``fused="auto"``), in a closed loop of whole rounds.

Set-up makes the weights and the traffic from the seed, builds one trainer
and its state, and drives them through the first round(s) with the
window's own call (``run(state, feed, 1, donate=True)``) and feed.  While
it does, a thin wrapper around the trainer's gradient function records
what the program produces at each of the first steps: the clients'
losses, the norms of the first gradient (as the tracking step receives
it), and the norms of x_t - x_0 (the iterate each step hands the
gradient).  The same trainer then runs the window, and with ``--trace 1``
a few profiled rounds after it.  Once the peak is read and the program's
state freed, the reference follows the same first steps from the same
weights and tokens (``perfbench.reference.depositum``), and
``perfbench.check`` compares.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import math
import time

import numpy as np
import torch

from perfbench import check, counts, trace
from perfbench.feed import TokenFeed
from perfbench.reference import depositum as reference
from perfbench.weights import make_weights


def nested(flat: dict):
    """``a.0.b`` -> {"a": [{"b": ...}]}: the program's parameter tree."""
    root: dict = {}
    for name, v in flat.items():
        node, parts = root, name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def listify(n):
        if not isinstance(n, dict):
            return n
        if n and all(k.isdigit() for k in n):
            return [listify(n[str(i)]) for i in range(len(n))]
        return {k: listify(v) for k, v in n.items()}

    return listify(root)


class Recorder:
    """The trainer's gradient function, recording the first steps.  The
    norms accumulate on the device; one copy to the host at the end."""

    def __init__(self, inner, plan: dict, x0_host: dict, clients: int):
        self.inner, self.x0, self.n = inner, x0_host, clients
        self.steps, self.dx_after = plan["steps"], set(plan["dx_after"])
        self.t = 0
        self.loss, self.grad1, self.dx = [], {}, {}

    def _norms(self, tree, base=None) -> dict:
        """leaf -> (clients,) float64 norms of tree (minus the host's
        ``base``, moved over once a chunk) on the device."""
        out = {}
        for k, v in tree.items():
            rows = v.reshape(self.n, -1)
            sq = torch.zeros(self.n, dtype=torch.float64, device=v.device)
            for i in range(0, rows.shape[1], reference.CHUNK):
                c = rows[:, i:i + reference.CHUNK].float()
                if base is not None:
                    c = c - base[k].reshape(-1)[i:i + reference.CHUNK].to(
                        v.device, non_blocking=True).float()
                sq += torch.sum(c * c, dim=1, dtype=torch.float64)
            out[k] = sq.sqrt()
        return out

    def __call__(self, x, batch):
        self.t += 1
        t = self.t
        if t in self.dx_after:
            self.dx[t] = self._norms(x, self.x0)
        g, aux = self.inner(x, batch)
        if t <= self.steps:
            self.loss.append(aux["ce"].detach().float().clone())
        if t == 1:
            self.grad1 = self._norms(g)
        return g, aux

    def readings(self) -> dict:
        host = lambda d: {k: v.cpu().numpy() for k, v in d.items()}
        return {"loss": torch.stack(self.loss).cpu().double().numpy(),
                "grad1": host(self.grad1),
                "dx": {t: host(d) for t, d in self.dx.items()}}


def build_program(cfg: dict, traffic: dict, seed: int, device, specs: list):
    """(trainer, state, the weights' host copy) from the family's leaf
    ``specs``."""
    from repro_torch.configs import get_config
    from repro_torch.core import DepositumConfig
    from repro_torch.models import build_model
    from repro_torch.training.train_loop import FederatedTrainer, TrainerConfig

    port = cfg["port"]
    pcfg = dataclasses.replace(get_config(port["arch"]), **port["fields"])
    cls = getattr(importlib.import_module(port["module"]), port["class"])
    weights = make_weights(specs, seed, device, cfg["model"]["dtype"])
    pin = torch.device(device).type == "cuda"
    x0_host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=pin).copy_(v)
               for k, v in weights.items()}
    module = cls(pcfg, nested(weights))
    got = {k: (tuple(p.shape), p.dtype) for k, p in module.named_parameters()}
    want = {k: (tuple(v.shape), v.dtype) for k, v in weights.items()}
    if got != want:
        raise RuntimeError("the program's parameters differ from the "
                           f"configuration's leaves: {sorted(set(got) ^ set(want))[:5]}")
    dep = traffic["depositum"]
    dcfg = DepositumConfig(
        alpha=dep["alpha"], beta=dep["beta"], gamma=dep["gamma"],
        momentum=dep["momentum"], comm_period=traffic["t0"],
        prox_name=dep["prox"], prox_kwargs={"lam": dep["lam"]},
        fused=dep["fused"])
    tc = TrainerConfig(n_clients=traffic["clients"],
                       topology=traffic["topology"], depositum=dcfg,
                       seed=seed, log_every=1)
    trainer = FederatedTrainer(build_model(pcfg, device=device), tc,
                               device=device)
    state = trainer.state_from_params(module)
    del module, weights
    return trainer, state, x0_host


def work_counts(cfg: dict, traffic: dict, specs: list) -> dict:
    """The operations and bytes of the cell's work (``perfbench.counts``),
    from the configuration, traffic and leaf ``specs`` alone; raises at
    once where the family lacks its work module."""
    fam, m, L, n = cfg["family"], cfg["model"], traffic["seq_len"], traffic["clients"]
    out = {"flops_per_token": counts.flops_per_token(fam, m, L),
           "attention_flops_per_token": counts.attention_flops_per_token(fam, m, L),
           "tokens_per_client_step": traffic["batch"] * L}
    out["sweep_bytes"] = counts.sweep_pair_bytes(specs, m["dtype"], n)
    out["gossip_bytes"] = counts.gossip_bytes(specs, m["dtype"], n)
    return out


def run(cfg: dict, traffic: dict, limits: dict, seed: int, seconds: float,
        traced: bool, device, t_start: float, program_hook=None) -> dict:
    """One run of a training cell; returns the numbers the result line
    and the metric readers need.  ``seconds=None`` stops after the first
    steps and the check (no window).  ``program_hook(trainer)``, where
    given, plants a change in the program before the first step and
    returns its undo (the benchmark's own runs pass none)."""
    specs = reference.family(cfg["family"]).leaf_specs(cfg["model"])
    work = work_counts(cfg, traffic, specs)
    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    n, T0 = traffic["clients"], traffic["t0"]
    tokens_a_round = T0 * n * traffic["batch"] * traffic["seq_len"]
    feed = TokenFeed(traffic, cfg["model"]["vocab_size"], seed)

    trainer, state, x0_host = build_program(cfg, traffic, seed, device, specs)
    built_s = time.perf_counter() - t_start
    undo = program_hook(trainer) if program_hook else None
    rec = Recorder(trainer._grad_fn, traffic["check"], x0_host, n)
    trainer._grad_fn = rec
    rounds_iter = feed.rounds(device)
    first = math.ceil(traffic["check"]["steps"] / T0)
    for _ in range(first):
        state, _h = trainer.run(state, rounds_iter, 1, donate=True)
    trainer._grad_fn = rec.inner
    prog = rec.readings()
    del x0_host, rec.x0
    sync()
    setup_s = time.perf_counter() - t_start

    losses, walls = [], []

    def advance():
        nonlocal state
        t = time.perf_counter()
        state, hist = trainer.run(state, rounds_iter, 1, donate=True)
        losses.append(hist[-1].get("loss", math.nan))
        walls.append(time.perf_counter() - t)

    window = tr = None
    if seconds is not None:
        t0 = time.perf_counter()
        rounds = 0
        while True:
            advance()
            rounds += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync()
        wall = time.perf_counter() - t0
        window = {"rounds": rounds, "wall_s": wall,
                  "tokens": rounds * tokens_a_round, "steps": rounds * T0,
                  "client_steps": rounds * T0 * n}
    if traced:
        k = traffic["trace_rounds"]
        tr = trace.capture(advance, k, cuda)
        tr.update(rounds=k, steps=k * T0, client_steps=k * T0 * n, comm_steps=k)
    peak = torch.cuda.max_memory_allocated() if cuda else None
    attempted = len(losses)
    failed = sum(1 for v in losses if not math.isfinite(v))

    if undo:
        undo()
    del state, trainer, rounds_iter
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    x0 = make_weights(specs, seed, device, cfg["model"]["dtype"])
    ref = reference.follow(
        cfg, traffic, x0,
        lambda t: torch.from_numpy(feed.step_tokens(t)).to(device))
    numbers = check.compare(prog, ref)
    ok = (check.verdict(numbers, limits) and failed == 0
          and (attempted > 0 or seconds is None))
    return {
        "correct": ok, "attempted": attempted, "failed": failed,
        "numbers": numbers, "setup_s": setup_s, "peak_bytes": peak,
        "window": window, "trace": tr, "reference_s": time.perf_counter() - t_ref,
        "counts": work,
        "round_s": walls, "prog": prog, "ref": ref,
        "setup_parts": {"to_built": built_s, "first_steps": setup_s - built_s},
    }
