"""Paper-scale models on labelled vectors (paper Sec. V-A).

Port of the linear and MLP models and the CE loss of
``benchmarks/common.py``.  The modules keep the reference's parameter
layout — ``w`` is ``(d_in, d_out)``, names ``w``/``b`` for the linear model
and ``l{i}.w``/``l{i}.b`` for the MLP — so a reference parameter pytree
maps onto ``named_parameters`` one to one (:mod:`repro_torch.convert`).

Training code works on dicts of client-stacked parameters and calls the
modules functionally (``torch.func.functional_call``); per-client
gradients are ``torch.func.vmap(torch.func.grad(...))`` over the stack.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call, grad, vmap

from repro_torch._device import resolve_device


class Dense(nn.Module):
    """``x @ w + b`` with ``w`` stored (d_in, d_out)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(d_in, d_out))
        self.b = nn.Parameter(torch.zeros(d_out))

    def forward(self, x):
        return x @ self.w + self.b


class LinearClassifier(Dense):
    """Multinomial logistic regression (``init_linear`` / ``apply_linear``)."""

    def __init__(self, d_in: int, n_classes: int):
        super().__init__(d_in, n_classes)


class MLP(nn.Module):
    """ReLU MLP ``d_in -> hidden... -> n_classes`` (``init_mlp`` /
    ``apply_mlp``)."""

    def __init__(self, d_in: int, n_classes: int, hidden=(64, 32)):
        super().__init__()
        self.dims = (d_in,) + tuple(hidden) + (n_classes,)
        for i in range(len(self.dims) - 1):
            setattr(self, f"l{i}", Dense(self.dims[i], self.dims[i + 1]))

    def forward(self, x):
        n = len(self.dims) - 1
        for i in range(n):
            x = getattr(self, f"l{i}")(x)
            if i < n - 1:
                x = torch.relu(x)
        return x


MODELS = {"linear": LinearClassifier, "mlp": MLP}


def init_params(model: nn.Module, seed: int = 0, *,
                device="cuda") -> dict[str, torch.Tensor]:
    """Random initial parameters of ``model`` as a name -> tensor dict.

    Weights are normal, scaled as the reference does (0.01 for the linear
    model, He ``sqrt(2 / d_in)`` for the MLP); biases zero.  Drawn on the
    CPU from ``torch.Generator().manual_seed(seed)`` (not the reference's
    JAX key stream: a test that needs equal weights converts the
    reference's with :func:`repro_torch.convert.params_from_numpy`).
    """
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params = {}
    for name, p in sorted(model.named_parameters()):
        if name.endswith("w"):
            scale = (0.01 if isinstance(model, LinearClassifier)
                     else (2.0 / p.shape[0]) ** 0.5)
            v = torch.randn(p.shape, generator=gen) * scale
        else:
            v = torch.zeros(p.shape)
        params[name] = v.to(dev)
    return params


def ce_loss(model: nn.Module, params: dict, batch: dict) -> torch.Tensor:
    """Mean cross-entropy of ``model`` under ``params`` on one batch."""
    logits = functional_call(model, params, (batch["x"],))
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["y"][..., None].long())[..., 0]
    return torch.mean(logz - gold)


def client_grad_fn(model: nn.Module):
    """``grad_fn(x_stacked, batch) -> (g_stacked, {})``: per-client
    minibatch gradients, every leaf and batch entry stacked on dim 0."""
    grad_one = vmap(grad(lambda p, b: ce_loss(model, p, b)))

    def grad_fn(x_stacked, batch):
        return grad_one(x_stacked, batch), {}

    return grad_fn


def stationarity_grad_fns(model: nn.Module, xs_full: torch.Tensor,
                          ys_full: torch.Tensor) -> dict:
    """The ``grad_fns`` of :func:`~repro_torch.core.depositum.
    stationarity_metrics` on full client data ``xs_full`` (C, N, d) /
    ``ys_full`` (C, N): ``local_at`` is each client's gradient on its own
    data, ``global_at`` the gradient on all data, at every client iterate."""
    loss = lambda p, b: ce_loss(model, p, b)
    local = {"x": xs_full, "y": ys_full}
    everything = {"x": xs_full.reshape(-1, xs_full.shape[-1]),
                  "y": ys_full.reshape(-1)}
    local_at = vmap(grad(loss))
    global_at = vmap(grad(loss), in_dims=(0, None))
    return {"local_at": lambda xst: local_at(xst, local),
            "global_at": lambda xst: global_at(xst, everything)}
