"""Pure Mamba2 language model, attention-free (port of
``repro/models/ssm.py``).

The reference scans stacked layers; the port keeps ``blocks`` a per-layer
list (``blocks.<i>.mamba.in_proj`` for layer i of the stacked
``blocks/mamba/in_proj``), as :mod:`repro_torch.models.transformer` does.
The embeddings are tied (mamba2-130m).  Prefill is the training forward
plus each layer's final conv inputs and SSD state; it needs no KV capacity
and ignores the one it is given.  The prompt length must be a multiple of
``cfg.ssm_chunk``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
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
from repro_torch.models.mamba2 import (
    init_mamba,
    init_mamba_cache,
    mamba_block,
    mamba_decode,
)
from repro_torch.models.transformer import initializer


def init_layer(ini, cfg: ModelConfig):
    """One residual Mamba2 layer: its pre-norm and the block."""
    return {"ln": init_rms_norm(ini, cfg.d_model),
            "mamba": init_mamba(ini, cfg)}


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """Returns (params, axes) with ``blocks`` a per-layer list; weights from
    a ``torch.Generator`` on ``device`` seeded with ``seed``."""
    ini = initializer(cfg, seed, device)
    V = pad_vocab(cfg.vocab_size)
    return split_params({
        "blocks": [init_layer(ini, cfg) for _ in range(cfg.n_layers)],
        "embed": init_embedding(ini, V, cfg.d_model),
        "final_norm": init_rms_norm(ini, cfg.d_model)})


def layer_train(params, h, cfg: ModelConfig):
    """A residual Mamba2 layer over the whole sequence: (h, its cache)."""
    out, cache = mamba_block(params["mamba"],
                             rms_norm(h, params["ln"]["scale"]), cfg)
    return h + out, cache


def layer_decode(params, h, cache, cfg: ModelConfig):
    out, cache = mamba_decode(params["mamba"],
                              rms_norm(h, params["ln"]["scale"]), cache, cfg)
    return h + out, cache


def init_decode_cache(cfg: ModelConfig, batch: int, capacity: int = 0,
                      device=None):
    """Per-layer Mamba caches (a list); ``capacity`` is not used."""
    return [init_mamba_cache(cfg, batch, cfg.torch_dtype, device=device)
            for _ in range(cfg.n_layers)]


class SSM(nn.Module):
    """Mamba2 LM over a params tree from :func:`init_params` (or from
    :func:`repro_torch.convert.model_params_from_numpy`)."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        if cfg.family != "ssm":
            raise ValueError(f"family {cfg.family!r} is not 'ssm'")
        self.cfg = cfg
        self.blocks = nn.ModuleList(ParamTree(b) for b in params["blocks"])
        self.embed = ParamTree(params["embed"])
        self.final_norm = ParamTree(params["final_norm"])

    def _embed(self, tokens):
        return embed(self.embed, tokens).to(self.cfg.torch_dtype)

    def _logits(self, x):
        x = rms_norm(x, self.final_norm["scale"])
        return torch.einsum("bld,vd->blv", x, self.embed["table"])

    def forward_train(self, batch: dict, *, window: int = 0):
        """Returns (logits, {"moe_aux": 0}); ``window`` is not used."""
        x = self._embed(batch["tokens"])
        body = maybe_checkpoint(lambda p, h: layer_train(p, h, self.cfg)[0],
                                self.cfg)
        for blk in self.blocks:
            x = body(blk.tensors(), x)
        return self._logits(x), {
            "moe_aux": torch.zeros((), dtype=torch.float32, device=x.device)}

    forward = forward_train

    def init_decode_cache(self, batch: int, capacity: int = 0):
        return init_decode_cache(self.cfg, batch, capacity,
                                 device=self.embed["table"].device)

    def forward_prefill(self, batch: dict, capacity: int = 0):
        """Full forward materialising each layer's conv and SSD state;
        logits of the last position only."""
        x = self._embed(batch["tokens"])
        caches = []
        for blk in self.blocks:
            x, c = layer_train(blk, x, self.cfg)
            caches.append(c)
        return self._logits(x[:, -1:, :]), caches

    def forward_decode(self, batch: dict, caches):
        x = self._embed(batch["tokens"])
        new = []
        for blk, cache in zip(self.blocks, caches):
            x, c = layer_decode(blk, x, cache, self.cfg)
            new.append(c)
        return self._logits(x), new
