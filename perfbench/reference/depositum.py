"""Plain reference of DEPOSITUM's first steps (the paper's Algorithm 1,
Polyak momentum, l1 prox), client by client, with a model of
``perfbench.reference`` as each client's loss.

Per step t = 1, 2, ... and client i, with W mixing only when t is a
multiple of T0:

    nu_i  <- gamma nu_i + (1 - gamma) y_i
    x_i   <- sum_j W_ij prox_{alpha lam |.|}(x_j - alpha nu_j)
    g'_i  <- grad f_i(x_i) on the client's batch of step t
    y_i   <- sum_j W_ij (y_j + beta (g'_j - g_j)),   g_i <- g'_i

Arithmetic is float32 (products through a ``Precision``).  The
configuration holds the parameters and the optimiser's trees in its dtype
(bf16), so each stored value is rounded to that dtype where the
configuration stores it, as it would be stored; the update itself reads
the unrounded nu.  Readings: each step's loss per client, the per-leaf,
per-client norms of the first gradient, and of x - x0 after the steps
asked for.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

from perfbench.reference.common import Precision, exact_fp32

F32 = torch.float32
CHUNK = 1 << 25


def mixing_matrix(topology: str, n: int) -> np.ndarray:
    """Complete: every weight 1/n.  Ring: Metropolis weights (1/2 for n = 2,
    1/3 for the two neighbours and itself from n = 3)."""
    if topology == "complete" or n == 1:
        return np.full((n, n), 1.0 / n)
    if topology == "ring":
        W = np.zeros((n, n))
        w = 0.5 if n == 2 else 1.0 / 3
        for i in range(n):
            for j in ((i + 1) % n, (i - 1) % n):
                W[i, j] = w
            W[i, i] = 1.0 - W[i].sum()
        return W
    raise ValueError(f"topology {topology!r}: complete | ring")


def sq_norm(t: torch.Tensor, sub: torch.Tensor | None = None) -> float:
    """Squared L2 norm of ``t`` (minus ``sub``) in float32 chunks, summed
    in float64."""
    a = t.reshape(-1)
    b = None if sub is None else sub.reshape(-1)
    total = 0.0
    for i in range(0, a.numel(), CHUNK):
        v = a[i:i + CHUNK].to(F32)
        if b is not None:
            v = v - b[i:i + CHUNK].to(device=v.device, dtype=F32)
        total += float(torch.sum(v * v, dtype=torch.float64))
    return total


def family(name: str):
    return importlib.import_module(f"perfbench.reference.{name}")


def follow(cfg: dict, traffic: dict, x0: dict, batches, *, precision="fp32"):
    """The reference's readings over ``traffic["check"]["steps"]`` steps
    from the weights ``x0`` (name -> tensor, one client's, in the
    configuration's dtype; every client starts from them).

    ``batches(t)`` gives step t's (clients, B, L + 1) token tensor on the
    device (t 0-based).  Returns {"loss": (steps, clients) array, "grad1":
    {leaf: (clients,) norms}, "dx": {step: {leaf: (clients,) norms}}}.
    """
    dep = traffic["depositum"]
    if dep["momentum"] != "polyak" or dep["prox"] != "l1":
        raise ValueError("the reference follows Polyak momentum and the l1 prox")
    m, fam, prec = cfg["model"], family(cfg["family"]), Precision(precision)
    n, T0 = traffic["clients"], traffic["t0"]
    steps, dx_after = traffic["check"]["steps"], set(traffic["check"]["dx_after"])
    a, b, g_, thr = dep["alpha"], dep["beta"], dep["gamma"], dep["alpha"] * dep["lam"]
    W = mixing_matrix(traffic["topology"], n)
    store = next(iter(x0.values())).dtype
    names = list(x0)
    x = [{k: v.clone() for k, v in x0.items()} for _ in range(n)]
    zero = lambda: [{k: torch.zeros_like(v) for k, v in x0.items()} for _ in range(n)]
    y, nu, g = zero(), zero(), zero()
    out = {"loss": np.zeros((steps, n)), "grad1": {}, "dx": {}}

    def mix(trees):
        for k in names:
            stacked = torch.stack([t[k].to(F32) for t in trees])
            mixed = torch.einsum("ij,j...->i...", torch.as_tensor(
                W, dtype=F32, device=stacked.device), stacked)
            for i, t in enumerate(trees):
                t[k] = mixed[i].to(store)

    with exact_fp32():
        for t in range(1, steps + 1):
            comm = t % T0 == 0
            for i in range(n):
                for k in names:
                    nv = g_ * nu[i][k].to(F32) + (1 - g_) * y[i][k].to(F32)
                    v = x[i][k].to(F32) - a * nv
                    x[i][k] = (torch.sign(v) * torch.clamp_min(v.abs() - thr, 0)).to(store)
                    nu[i][k] = nv.to(store)
            if comm:
                mix(x)
            tok = batches(t - 1)
            for i in range(n):
                params = {k: v.to(F32).requires_grad_() for k, v in x[i].items()}
                loss = fam.loss(params, tok[i, :, :-1], tok[i, :, 1:], m, prec)
                grads = torch.autograd.grad(loss, [params[k] for k in names])
                out["loss"][t - 1, i] = float(loss.detach())
                del params, loss
                for k, gk in zip(names, grads):
                    if t == 1:
                        out["grad1"].setdefault(k, np.zeros(n))[i] = sq_norm(gk) ** 0.5
                    y[i][k] = (y[i][k].to(F32) + b * (gk - g[i][k].to(F32))).to(store)
                    g[i][k] = gk.to(store)
                del grads
            if comm:
                mix(y)
            if t in dx_after:
                out["dx"][t] = {k: np.array([sq_norm(x[i][k], x0[k]) ** 0.5
                                             for i in range(n)]) for k in names}
    return out
