"""Decoder-only transformer backbone, dense family (port of
``repro/models/transformer.py``).

The reference stacks parameters over layers and scans them; the port keeps
one :class:`~repro_torch.models.common.ParamTree` per layer in an
``nn.ModuleList`` and loops over them eagerly.  Parameter paths match the
reference's (``blocks.<i>.attn.wq`` for layer i of the stacked
``blocks/attn/wq``), so :mod:`repro_torch.convert` carries weights across
one leaf at a time.  With ``cfg.remat`` a training forward checkpoints
each block (:func:`~repro_torch.models.common.maybe_checkpoint`, the
reference's per-layer ``jax.checkpoint``); serving runs without grad and
never recomputes.  MoE and VLM blocks arrive with their slices.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import (
    Initializer,
    ParamTree,
    embed,
    init_embedding,
    init_rms_norm,
    maybe_checkpoint,
    pad_vocab,
    rms_norm,
    split_params,
)
from repro_torch.models.mlp import init_mlp, mlp


def _require_dense(cfg: ModelConfig):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} arrives with its slice (ROADMAP Queue 1 "
            "item 10); the port's transformer runs the dense family")


# ---------------------------------------------------------------------------
# One decoder block
# ---------------------------------------------------------------------------

def init_block(ini: Initializer, cfg: ModelConfig):
    return {
        "ln1": init_rms_norm(ini, cfg.d_model),
        "attn": attn.init_attention(ini, cfg),
        "ln2": init_rms_norm(ini, cfg.d_model),
        "mlp": init_mlp(ini, cfg),
    }


def block_train(params, x, cfg: ModelConfig, *, window: int = 0,
                use_flash: bool = False):
    h = attn.attention_train(params["attn"], rms_norm(x, params["ln1"]["scale"]),
                             cfg, window=window, use_flash=use_flash)
    x = x + h
    return x + mlp(params["mlp"], rms_norm(x, params["ln2"]["scale"]), cfg)


def block_decode(params, x, cache: attn.KVCache, cfg: ModelConfig):
    h, cache = attn.attention_decode(
        params["attn"], rms_norm(x, params["ln1"]["scale"]), cache, cfg)
    x = x + h
    return x + mlp(params["mlp"], rms_norm(x, params["ln2"]["scale"]), cfg), cache


def block_prefill(params, x, cfg: ModelConfig, capacity: int):
    h, cache = attn.attention_prefill(
        params["attn"], rms_norm(x, params["ln1"]["scale"]), cfg, capacity)
    x = x + h
    return x + mlp(params["mlp"], rms_norm(x, params["ln2"]["scale"]), cfg), cache


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, *, seed: int = 0, device="cpu"):
    """Returns (params, axes): nested dicts with ``blocks`` a per-layer list
    (each layer's leaves carry their own axes, without the reference's
    stacked ``layers`` axis).

    Weights are drawn from a ``torch.Generator`` on ``device`` seeded with
    ``seed``; ``device="meta"`` gives the shapes without memory.
    """
    _require_dense(cfg)
    dev = torch.device(device)
    gen = None if dev.type == "meta" else torch.Generator(
        device=dev).manual_seed(seed)
    ini = Initializer(gen, cfg.torch_dtype, device=dev)
    V = pad_vocab(cfg.vocab_size)
    tree = {"blocks": [init_block(ini, cfg) for _ in range(cfg.n_layers)],
            "embed": init_embedding(ini, V, cfg.d_model),
            "final_norm": init_rms_norm(ini, cfg.d_model)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"w": ini.normal((cfg.d_model, V),
                                           ("embed", "vocab"), scale=0.02)}
    return split_params(tree)


def init_decode_cache(cfg: ModelConfig, batch: int, capacity: int,
                      device=None):
    """Per-layer KV caches (a list, one ``KVCache`` a layer)."""
    return [attn.init_kv_cache(cfg, batch, capacity, cfg.torch_dtype,
                               device=device)
            for _ in range(cfg.n_layers)]


class Transformer(nn.Module):
    """Dense decoder over a params tree from :func:`init_params` (or from
    :func:`repro_torch.convert.transformer_params_from_numpy`)."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        _require_dense(cfg)
        self.cfg = cfg
        self.blocks = nn.ModuleList(ParamTree(b) for b in params["blocks"])
        self.embed = ParamTree(params["embed"])
        self.final_norm = ParamTree(params["final_norm"])
        if not cfg.tie_embeddings:
            self.lm_head = ParamTree(params["lm_head"])

    def _embed(self, tokens):
        return embed(self.embed, tokens).to(self.cfg.torch_dtype)

    def _logits(self, x):
        x = rms_norm(x, self.final_norm["scale"])
        if self.cfg.tie_embeddings:
            return torch.einsum("bld,vd->blv", x, self.embed["table"])
        return x @ self.lm_head["w"]

    def forward_train(self, batch: dict, *, window: int = 0,
                      use_flash: bool = False):
        """Full causal forward.  Returns (logits, aux_losses dict)."""
        x = self._embed(batch["tokens"])
        body = maybe_checkpoint(block_train, self.cfg)
        for blk in self.blocks:
            x = body(blk.tensors(), x, self.cfg, window=window,
                     use_flash=use_flash)
        return self._logits(x), {"moe_aux": 0.0}

    forward = forward_train

    def init_decode_cache(self, batch: int, capacity: int):
        return init_decode_cache(self.cfg, batch, capacity,
                                 device=self.embed["table"].device)

    def forward_decode(self, batch: dict, caches):
        """One-token decode. batch: {"tokens": (B, 1)}; caches: per layer."""
        x = self._embed(batch["tokens"])
        new = []
        for blk, cache in zip(self.blocks, caches):
            x, c = block_decode(blk, x, cache, self.cfg)
            new.append(c)
        return self._logits(x), new

    def forward_prefill(self, batch: dict, capacity: int):
        """Full forward + cache materialisation; logits of the last position
        only (the final norm is per row, so it is applied to that row)."""
        x = self._embed(batch["tokens"])
        caches = []
        for blk in self.blocks:
            x, c = block_prefill(blk, x, self.cfg, capacity)
            caches.append(c)
        return self._logits(x[:, -1:, :]), caches
