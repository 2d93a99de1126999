"""Unified model interface (port of ``repro/models/registry.py``).

The port's ``params`` is the model itself, an ``nn.Module`` holding the
weights: ``model.init(seed)`` returns ``(module, axes)`` and every callable
takes the module where the reference takes its params pytree.  Every
family of the zoo builds: dense, MoE, VLM and the port's own ``mla_moe``
(DeepSeek-V2, training only) on
:class:`~repro_torch.models.transformer.Transformer`, SSM on
:class:`~repro_torch.models.ssm.SSM`, hybrid on
:class:`~repro_torch.models.hybrid.Hybrid`, and the encoder-decoder on
:class:`~repro_torch.models.encdec.EncDec`, which has no
``forward_prefill`` (as in the reference: its prompt is fed token by
token) and whose ``init_decode_cache`` takes the memory's length
(``memory_len``).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, hybrid, ssm, transformer
from repro_torch.models.common import cast
from repro_torch.obs import trace


def cross_entropy(logits, labels, mask=None):
    """Mean token CE. logits: (B,L,V) labels: (B,L) int; mask (B,L) opt."""
    logits = cast(logits, torch.float32)
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
    """Mean token CE plus ``router_aux_weight`` times the router loss; a
    VLM's logits over its vision positions are sliced off first (the
    labels cover the text)."""
    cfg = module.cfg
    logits, aux = module.forward_train(batch)
    labels = batch["labels"]
    if cfg.family == "vlm":
        logits = logits[:, logits.shape[1] - labels.shape[1]:, :]
    ce = trace.layer("ce", cross_entropy, logits, labels,
                     batch.get("loss_mask"))
    total = ce + cfg.router_aux_weight * aux.get("moe_aux", 0.0)
    return total, {"ce": ce, **aux}


#: family -> (its module, its nn.Module class)
_BACKBONES = {
    "dense": (transformer, transformer.Transformer),
    "moe": (transformer, transformer.Transformer),
    "vlm": (transformer, transformer.Transformer),
    "mla_moe": (transformer, transformer.Transformer),
    "ssm": (ssm, ssm.SSM),
    "hybrid": (hybrid, hybrid.Hybrid),
    "encdec": (encdec, encdec.EncDec),
}


def build_model(cfg: ModelConfig, *, device="cuda") -> Model:
    """The :class:`Model` of ``cfg``'s family; ``init`` and
    ``init_decode_cache`` build on ``device`` (raises without a card unless
    ``device="cpu"``)."""
    if cfg.family not in _BACKBONES:
        raise ValueError(f"unknown family {cfg.family!r}")
    mod, cls = _BACKBONES[cfg.family]
    device = resolve_device(device)

    def init(seed: int = 0):
        params, axes = mod.init_params(cfg, seed=seed, device=device)
        return cls(cfg, params), axes

    return Model(
        cfg=cfg,
        init=init,
        forward_train=lambda m, b, **kw: m.forward_train(b, **kw),
        loss=_loss,
        forward_decode=lambda m, b, cache: m.forward_decode(b, cache),
        # capacity: the KV slots (the SSM family needs none); the enc-dec
        # also takes memory_len
        init_decode_cache=lambda batch, *capacity, **kw: mod.init_decode_cache(
            cfg, batch, *capacity, device=device, **kw),
        forward_prefill=None if cfg.family == "encdec" else (
            lambda m, b, *capacity: m.forward_prefill(b, *capacity)),
    )
