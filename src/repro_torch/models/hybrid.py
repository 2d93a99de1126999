"""Zamba2-style hybrid backbone [arXiv:2411.15242] (port of
``repro/models/hybrid.py``): Mamba2 layers with one *shared* attention+MLP
transformer block invoked every ``shared_attn_every`` layers (weights
reused at each invocation; the published model adds per-invocation LoRA
deltas, the reference shares fully and so does the port).

Layout for n_layers=54, every=6: 9 groups, each 5 Mamba2 layers then the
shared block.  The reference stacks the Mamba2 leaves ``(n_groups,
per_group, ...)``; the port keeps ``mamba`` a list of groups, each a list
of per-layer trees (``mamba.<g>.<j>.ln.scale``).  The shared block's
prefill attention runs through the flash kernel.  Its decode cache,
:class:`HybridCache`, holds each group's Mamba caches and one KV cache a
shared invocation.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import (
    ParamTree,
    embed,
    init_embedding,
    init_rms_norm,
    maybe_checkpoint,
    pad_vocab,
    rms_norm,
    split_params,
)
from repro_torch.models.mamba2 import init_mamba_cache
from repro_torch.models.mlp import init_mlp, mlp
from repro_torch.models.ssm import init_layer, layer_decode, layer_train
from repro_torch.models.transformer import initializer


def group_shape(cfg: ModelConfig) -> tuple[int, int]:
    """(n_groups, Mamba2 layers a group)."""
    every = cfg.shared_attn_every
    if every < 2 or cfg.n_layers % every:
        raise ValueError(f"hybrid needs n_layers ({cfg.n_layers}) divisible "
                         f"by shared_attn_every ({every}) >= 2")
    return cfg.n_layers // every, every - 1


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """Returns (params, axes); weights from a ``torch.Generator`` on
    ``device`` seeded with ``seed``."""
    n_groups, per_group = group_shape(cfg)
    ini = initializer(cfg, seed, device)
    V = pad_vocab(cfg.vocab_size)
    return split_params({
        "mamba": [[init_layer(ini, cfg) for _ in range(per_group)]
                  for _ in range(n_groups)],
        "shared": {"ln1": init_rms_norm(ini, cfg.d_model),
                   "attn": attn.init_attention(ini, cfg),
                   "ln2": init_rms_norm(ini, cfg.d_model),
                   "mlp": init_mlp(ini, cfg)},
        "embed": init_embedding(ini, V, cfg.d_model),
        "final_norm": init_rms_norm(ini, cfg.d_model),
        "lm_head": {"w": ini.normal((cfg.d_model, V), ("embed", "vocab"),
                                    scale=0.02)}})


class HybridCache(NamedTuple):
    mamba: list      # n_groups lists of per_group MambaCache
    kv: list         # n_groups KVCache, one a shared invocation


def init_decode_cache(cfg: ModelConfig, batch: int, capacity: int,
                      device=None) -> HybridCache:
    n_groups, per_group = group_shape(cfg)
    dtype = cfg.torch_dtype
    return HybridCache(
        mamba=[[init_mamba_cache(cfg, batch, dtype, device=device)
                for _ in range(per_group)] for _ in range(n_groups)],
        kv=[attn.init_kv_cache(cfg, batch, capacity, dtype, device=device)
            for _ in range(n_groups)])


def _shared_mlp(sp, h, cfg: ModelConfig):
    return h + mlp(sp["mlp"], rms_norm(h, sp["ln2"]["scale"]), cfg)


def group_train(group, sp, h, cfg: ModelConfig, window: int = 0):
    """One group over the whole sequence: its Mamba2 layers, then the
    shared block (attention without a cache)."""
    for layer in group:
        h = layer_train(layer, h, cfg)[0]
    h = h + attn.attention_train(sp["attn"], rms_norm(h, sp["ln1"]["scale"]),
                                 cfg, window=window)
    return _shared_mlp(sp, h, cfg)


class Hybrid(nn.Module):
    """Zamba2 backbone over a params tree from :func:`init_params` (or from
    :func:`repro_torch.convert.model_params_from_numpy`)."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        if cfg.family != "hybrid":
            raise ValueError(f"family {cfg.family!r} is not 'hybrid'")
        group_shape(cfg)
        self.cfg = cfg
        self.mamba = nn.ModuleList(
            nn.ModuleList(ParamTree(layer) for layer in group)
            for group in params["mamba"])
        self.shared = ParamTree(params["shared"])
        self.embed = ParamTree(params["embed"])
        self.final_norm = ParamTree(params["final_norm"])
        self.lm_head = ParamTree(params["lm_head"])

    def _embed(self, tokens):
        return embed(self.embed, tokens).to(self.cfg.torch_dtype)

    def _logits(self, x):
        return rms_norm(x, self.final_norm["scale"]) @ self.lm_head["w"]

    def forward_train(self, batch: dict, *, window: int = 0):
        """Returns (logits, {"moe_aux": 0}); with ``cfg.remat`` each group
        is checkpointed, as the reference checkpoints its group body."""
        x = self._embed(batch["tokens"])
        body = maybe_checkpoint(group_train, self.cfg)
        sp = self.shared.tensors()
        for group in self.mamba:
            x = body([layer.tensors() for layer in group], sp, x, self.cfg,
                     window)
        return self._logits(x), {
            "moe_aux": torch.zeros((), dtype=torch.float32, device=x.device)}

    forward = forward_train

    def init_decode_cache(self, batch: int, capacity: int):
        return init_decode_cache(self.cfg, batch, capacity,
                                 device=self.embed["table"].device)

    def forward_prefill(self, batch: dict, capacity: int):
        """Full forward materialising the Mamba states and the shared
        block's KV caches; logits of the last position only."""
        x = self._embed(batch["tokens"])
        sp, mcaches, kvs = self.shared, [], []
        for group in self.mamba:
            caches = []
            for layer in group:
                x, c = layer_train(layer, x, self.cfg)
                caches.append(c)
            a, kv = attn.attention_prefill(
                sp["attn"], rms_norm(x, sp["ln1"]["scale"]), self.cfg,
                capacity)
            x = _shared_mlp(sp, x + a, self.cfg)
            mcaches.append(caches)
            kvs.append(kv)
        return self._logits(x[:, -1:, :]), HybridCache(mamba=mcaches, kv=kvs)

    def forward_decode(self, batch: dict, cache: HybridCache):
        x = self._embed(batch["tokens"])
        sp, mcaches, kvs = self.shared, [], []
        for group, gcache, kv in zip(self.mamba, cache.mamba, cache.kv):
            caches = []
            for layer, c in zip(group, gcache):
                x, c = layer_decode(layer, x, c, self.cfg)
                caches.append(c)
            a, kv = attn.attention_decode(
                sp["attn"], rms_norm(x, sp["ln1"]["scale"]), kv, self.cfg)
            x = _shared_mlp(sp, x + a, self.cfg)
            mcaches.append(caches)
            kvs.append(kv)
        return self._logits(x), HybridCache(mamba=mcaches, kv=kvs)
