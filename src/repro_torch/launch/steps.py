"""Step builders shared by the launchers (port of ``repro/launch/steps.py``).

* :func:`make_grad_fn` / :func:`make_value_grad_fn` — per-client
  gradients of a model's loss over stacked ``(C, ...)`` parameters;
* ``build_train_step`` — one full DEPOSITUM iteration (momentum + prox +
  gossip + fresh grads + tracking) for all clients: the communication
  step, the worst case for collectives;
* ``build_local_step`` — the collective-free local iteration;
* ``build_serve_step`` / ``build_prefill_step`` — one decode step, and the
  prompt's forward (an enc-dec's: encode the frames, then the decoder's
  prompt against the memory), under ``torch.inference_mode()``.

The reference maps ``jax.value_and_grad`` over the client axis with
``jax.vmap``.  Here the clients run one after another through
``torch.autograd.grad``: ``torch.func`` transforms reject the
checkpointing of a remat config (saved-tensor hooks), and a batched
backward at full width would hold every client's activations at once.
Client i's parameters are ``x[name][i].detach().requires_grad_()`` views
of the stacked state (no copy); its gradients are copied into row i of a
``(C, ...)`` buffer allocated once a step and freed before the next
client runs.  The sweep engine keeps its own ``torch.func.vmap``
gradients (``repro_torch.training.sweep``); these grad functions are not
for it.

A model's parameters are a flat ``name -> tensor`` dict.  For a model
whose ``init`` returns an ``nn.Module`` (the zoo's), pass that module as
``template``: the loss then runs the module through
``torch.func.functional_call`` with client i's tensors in place of its
own (the module's own weights may live on ``meta``).  A model whose
``init`` returns a dict takes the dict itself (``template=None``).
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Any, Optional

import torch
from torch import nn
from torch.func import functional_call

from repro_torch.core import DepositumConfig, identity_mixer
from repro_torch.core.depositum import step as depositum_step
from repro_torch.core.mixing import MixPlan
from repro_torch.core.schedule import MixSchedule
from repro_torch.models.registry import Model

if TYPE_CHECKING:   # the training package imports this module
    from repro_torch.training.backends import ExecutionBackend


class _Loss(nn.Module):
    """``model.loss(net, batch)`` as a module, so ``functional_call`` can
    put a client's tensors in place of ``net``'s parameters."""

    def __init__(self, loss, net: nn.Module):
        super().__init__()
        self.net = net
        self._loss = loss

    def forward(self, batch):
        return self._loss(self.net, batch)


def _loss_fn(model: Model, template: Optional[nn.Module] = None):
    """``(params, batch) -> (loss, aux)`` of ``model`` on a flat params
    dict; through ``template`` for a module model (see the module
    docstring)."""
    if template is None:
        return model.loss
    wrapper = _Loss(model.loss, template)

    def loss(params, batch):
        return functional_call(
            wrapper, {f"net.{k}": v for k, v in params.items()}, (batch,),
            strict=True)

    return loss


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _client_value_grad(loss, params: dict, batch: Any, microbatch: int):
    """(loss, aux, grads) of one client; with ``microbatch = M > 1`` the
    batch runs as M slabs of B/M, one after another, and the gradients
    are their mean (the loss and aux are the last slab's)."""
    slabs = [batch] if microbatch <= 1 else [
        _map(lambda v, m=m: v.reshape((microbatch, v.shape[0] // microbatch)
                                      + v.shape[1:])[m], batch)
        for m in range(microbatch)]
    gsum = None
    for b in slabs:
        with torch.enable_grad():
            leaves = {k: v.detach().requires_grad_() if v.is_floating_point()
                      else v.detach() for k, v in params.items()}
            wrt = [k for k, v in leaves.items() if v.requires_grad]
            value, aux = loss(leaves, b)
            got = torch.autograd.grad(value, [leaves[k] for k in wrt],
                                      allow_unused=True)
        got = dict(zip(wrt, got))
        grads = {k: got[k] if got.get(k) is not None else torch.zeros_like(v)
                 for k, v in leaves.items()}
        del got, leaves
        gsum = grads if gsum is None else {k: gsum[k] + g
                                           for k, g in grads.items()}
        del grads
    if microbatch > 1:
        gsum = {k: v / microbatch for k, v in gsum.items()}
    return value.detach(), aux, gsum


def _stack_aux(auxs: list):
    """Per-client aux dicts -> one dict of (C,) values (tensors detached;
    Python numbers as a CPU tensor)."""
    if not auxs or not isinstance(auxs[0], dict):
        return auxs[0] if auxs else {}
    out = {}
    for k in auxs[0]:
        vals = [a[k] for a in auxs]
        out[k] = (torch.stack([v.detach() for v in vals])
                  if isinstance(vals[0], torch.Tensor) else torch.tensor(vals))
    return out


def _stacked(loss, microbatch: int, with_value: bool):
    def grad_fn(x_stacked: dict, batch: Any):
        n = next(iter(x_stacked.values())).shape[0]
        g = {k: torch.empty_like(v) for k, v in x_stacked.items()}
        values, auxs = [], []
        for i in range(n):
            value, aux, grads = _client_value_grad(
                loss, {k: v[i] for k, v in x_stacked.items()},
                _map(lambda v: v[i], batch), microbatch)
            for k, gk in grads.items():
                g[k][i].copy_(gk)
            del grads       # this client's autograd output, before the next
            values.append(value)
            auxs.append(aux)
        aux = _stack_aux(auxs)
        if with_value:
            aux = dict(aux) if isinstance(aux, dict) else {}
            aux.setdefault("loss", torch.stack(values))
        return g, aux

    return grad_fn


def make_grad_fn(model: Model, microbatch: int = 1, *,
                 template: Optional[nn.Module] = None):
    """Per-client gradients ``grad_fn(x_stacked, batch) -> (g, aux)``;
    optional gradient-accumulation microbatching.

    With ``microbatch = M > 1`` each client's batch B runs as M slabs of
    B/M, averaging the gradients: the full-batch mean, with activation
    memory cut ~M-fold.  ``aux`` holds the model's aux per client.
    """
    return _stacked(_loss_fn(model, template), microbatch, with_value=False)


def make_value_grad_fn(model: Model, *, template: Optional[nn.Module] = None):
    """Per-client gradients with the scalar loss joined into the aux
    (``{"loss": (C,)}``), so the trainer's history has one even when the
    model's own aux carries no ``"ce"``.  The gradients are
    :func:`make_grad_fn`'s."""
    return _stacked(_loss_fn(model, template), 1, with_value=True)


def build_train_step(
    model: Model,
    dep_cfg: DepositumConfig,
    n_clients: int,
    topology: str = "ring",
    mixer=None,
    microbatch: int = 1,
    plan: MixPlan | None = None,
    backend: "ExecutionBackend | None" = None,
    schedule: MixSchedule | None = None,
    *,
    template: Optional[nn.Module] = None,
    device="cuda",
):
    """(state, batch) -> (state, aux); batch leaves (n, B, ...).

    Mixing resolves in priority order: an explicit ``mixer`` closure, else
    a round-indexed ``schedule``, else a ``plan`` / ``topology`` (on
    ``device``), executed by ``backend`` (default stacked-vmap).
    """
    if mixer is None:
        from repro_torch.training.backends import StackedVmapBackend

        operand = schedule
        if operand is None:
            operand = (plan if plan is not None else MixPlan.from_topology(
                topology, n_clients, device=device))
        mixer = (backend or StackedVmapBackend()).mixer_for(operand)
    grad_fn = make_grad_fn(model, microbatch=microbatch, template=template)

    def train_step(state, batch):
        return depositum_step(state, batch, grad_fn, dep_cfg, mixer,
                              is_comm_step=True)

    return train_step


def build_local_step(model: Model, dep_cfg: DepositumConfig, *,
                     template: Optional[nn.Module] = None):
    grad_fn = make_grad_fn(model, template=template)

    def local_step(state, batch):
        return depositum_step(state, batch, grad_fn, dep_cfg, identity_mixer,
                              is_comm_step=False)

    return local_step


def build_serve_step(model: Model):
    """``(params, cache, batch) -> (logits, cache)``: one decode step."""
    def serve_step(params, cache, batch):
        with torch.inference_mode():
            return model.forward_decode(params, batch, cache)

    return serve_step


def build_prefill_step(model: Model, capacity: int):
    """``(params, batch) -> (last-position logits, cache)``.

    The enc-dec family has no ``forward_prefill``: its step takes ``batch
    = {"frames", "tokens"}``, encodes the frames under the config's
    ``long_context_window`` and runs the decoder's prompt against that
    memory, every attention through the flash kernel (the encoder's and
    the cross-attention non-causal, the decoder's self-attention causal),
    and returns ``(logits[:, -1:], memory)``; ``capacity`` is unused
    there, as in the reference.  Every other family returns
    ``model.forward_prefill(params, batch, capacity)``.
    """
    cfg = model.cfg
    if cfg.family == "encdec":
        def prefill_step(params, batch):
            with torch.inference_mode():
                memory = params.encode(batch["frames"],
                                       window=cfg.long_context_window,
                                       use_flash=True)
                logits, _ = params.forward_train(
                    {"tokens": batch["tokens"]}, memory=memory,
                    use_flash=True)
            return logits[:, -1:], memory

        return prefill_step

    def prefill_step(params, batch):
        with torch.inference_mode():
            return model.forward_prefill(params, batch, capacity)

    return prefill_step
