"""Unified model interface (port of ``repro/models/registry.py``).

The port's ``params`` is the model itself, an ``nn.Module`` holding the
weights: ``model.init(seed)`` returns ``(module, axes)`` and every callable
takes the module where the reference takes its params pytree.  Families
other than dense raise ``NotImplementedError`` until their slice lands.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def cross_entropy(logits, labels, mask=None):
    """Mean token CE. logits: (B,L,V) labels: (B,L) int; mask (B,L) opt."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None].long(),
                                dim=-1)[..., 0]
    nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable[..., tuple[Any, Any]]        # seed -> (module, axes)
    forward_train: Callable[..., tuple[Any, Any]]
    loss: Callable[..., tuple[torch.Tensor, dict]]
    forward_decode: Callable[..., tuple[Any, Any]]
    init_decode_cache: Callable[..., Any]
    forward_prefill: Optional[Callable[..., tuple[Any, Any]]] = None


def _loss(module, batch):
    """Mean token CE (the dense family has no router auxiliary loss)."""
    logits, aux = module.forward_train(batch)
    ce = cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
    return ce, {"ce": ce, **aux}


def build_model(cfg: ModelConfig, *, device="cuda") -> Model:
    """The dense family's :class:`Model`; ``init`` and
    ``init_decode_cache`` build on ``device`` (raises without a card unless
    ``device="cpu"``)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} arrives with its slice (ROADMAP Queue 1 "
            "item 10): MoE, VLM, SSM/Mamba2, hybrid and enc-dec are still "
            "to port")

    device = resolve_device(device)

    def init(seed: int = 0):
        params, axes = transformer.init_params(cfg, seed=seed, device=device)
        return transformer.Transformer(cfg, params), axes

    return Model(
        cfg=cfg,
        init=init,
        forward_train=lambda m, b, **kw: m.forward_train(b, **kw),
        loss=_loss,
        forward_decode=lambda m, b, cache: m.forward_decode(b, cache),
        init_decode_cache=lambda batch, capacity, **kw: (
            transformer.init_decode_cache(cfg, batch, capacity,
                                          device=device)),
        forward_prefill=lambda m, b, capacity: m.forward_prefill(b, capacity),
    )

