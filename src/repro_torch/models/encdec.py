"""Seamless-M4T-style encoder-decoder backbone [arXiv:2308.11596] (port of
``repro/models/encdec.py``).

The speech frontend (mel filterbank + conv feature extractor) is the
reference's stub: the batch provides precomputed *frame embeddings*
``(B, S, d_model)``.  The encoder is a stack of bidirectional transformer
blocks (:func:`~repro_torch.models.attention.attention_bidir`, optionally
under a symmetric window), the text decoder a causal transformer with
cross-attention to the encoder's memory.

As in :mod:`~repro_torch.models.transformer`, the reference's stacked
``encoder`` / ``decoder`` leaves are per-layer
:class:`~repro_torch.models.common.ParamTree`\\ s in ``nn.ModuleList``\\ s
(``encoder.<i>.attn.wq`` for layer i of ``encoder/attn/wq``), run in a
Python loop; with ``cfg.remat`` a training forward checkpoints each block,
as the reference's scan bodies do.  ``use_flash`` runs the encoder's and
the decoder's attention through the flash kernel (non-causal for the
encoder and the cross-attention, causal for the decoder's self-attention).
The training forward's default, ``None``, lets the decoder's causal
self-attention choose its route as every decoder family's does
(:func:`~repro_torch.models.attention.attention_train`: the training
kernels on the card in bf16, ``_sdpa`` elsewhere, counted on the card);
the encoder and the cross-attention then compute ``_sdpa``, since the
non-causal kernel has no backward.  Decode feeds one token against the decoder's per-layer
KV caches and the fixed memory: its self-attention is the plain ring-cache
path, its cross-attention the kernel (``Lq = 1`` against the memory's
``S`` rows), the memory's keys and values projected anew every step as the
reference does.  The family has no prefill: ``BatchedServer`` feeds the
prompt token by token, and ``launch.steps.build_prefill_step`` encodes
and runs the decoder's prompt forward in one call.
"""
from __future__ import annotations

from typing import NamedTuple

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
from repro_torch.models.transformer import initializer


def _require_encdec(cfg: ModelConfig):
    if cfg.family != "encdec":
        raise ValueError(f"family {cfg.family!r} is not the encoder-decoder "
                         "family")


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def init_enc_layer(ini: Initializer, cfg: ModelConfig):
    return {
        "ln1": init_rms_norm(ini, cfg.d_model),
        "attn": attn.init_attention(ini, cfg),
        "ln2": init_rms_norm(ini, cfg.d_model),
        "mlp": init_mlp(ini, cfg),
    }


def init_dec_layer(ini: Initializer, cfg: ModelConfig):
    return {
        "ln1": init_rms_norm(ini, cfg.d_model),
        "self_attn": attn.init_attention(ini, cfg),
        "ln_x": init_rms_norm(ini, cfg.d_model),
        "cross_attn": attn.init_cross_attention(ini, cfg),
        "ln2": init_rms_norm(ini, cfg.d_model),
        "mlp": init_mlp(ini, cfg),
    }


def enc_block(params, h, cfg: ModelConfig, *, window: int = 0,
              use_flash: bool = False):
    h = h + attn.attention_bidir(params["attn"],
                                 rms_norm(h, params["ln1"]["scale"]), cfg,
                                 window=window, use_flash=use_flash)
    return h + mlp(params["mlp"], rms_norm(h, params["ln2"]["scale"]), cfg)


def _cross_and_mlp(params, h, memory, cfg: ModelConfig, use_flash: bool):
    h = h + attn.cross_attention(params["cross_attn"],
                                 rms_norm(h, params["ln_x"]["scale"]),
                                 memory, cfg, use_flash=use_flash)
    return h + mlp(params["mlp"], rms_norm(h, params["ln2"]["scale"]), cfg)


def dec_block_train(params, h, memory, cfg: ModelConfig, *,
                    use_flash: bool | None = None):
    h = h + attn.attention_train(params["self_attn"],
                                 rms_norm(h, params["ln1"]["scale"]), cfg,
                                 use_flash=use_flash)
    return _cross_and_mlp(params, h, memory, cfg, bool(use_flash))


def dec_block_decode(params, h, memory, cache: attn.KVCache,
                     cfg: ModelConfig):
    a, cache = attn.attention_decode(params["self_attn"],
                                     rms_norm(h, params["ln1"]["scale"]),
                                     cache, cfg)
    return _cross_and_mlp(params, h + a, memory, cfg, True), cache


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """Returns (params, axes): ``encoder`` and ``decoder`` per-layer lists,
    ``embed``, ``enc_norm``, ``final_norm`` and ``lm_head``; weights drawn
    from a ``torch.Generator`` on ``device`` seeded with ``seed``."""
    _require_encdec(cfg)
    ini = initializer(cfg, seed, device)
    V = pad_vocab(cfg.vocab_size)
    tree = {
        "encoder": [init_enc_layer(ini, cfg)
                    for _ in range(cfg.n_encoder_layers)],
        "decoder": [init_dec_layer(ini, cfg) for _ in range(cfg.n_layers)],
        "embed": init_embedding(ini, V, cfg.d_model),
        "enc_norm": init_rms_norm(ini, cfg.d_model),
        "final_norm": init_rms_norm(ini, cfg.d_model),
        "lm_head": {"w": ini.normal((cfg.d_model, V), ("embed", "vocab"),
                                    scale=0.02)},
    }
    return split_params(tree)


class EncDecCache(NamedTuple):
    kv: list                 # decoder self-attention caches, one a layer
    memory: torch.Tensor     # (B, S, d) encoder output


def init_decode_cache(cfg: ModelConfig, batch: int, capacity: int,
                      memory_len: int = 0, *, device=None) -> EncDecCache:
    """Per-layer KV caches and a zero memory of ``memory_len`` rows (the
    caller puts the encoder's output there)."""
    kv = [attn.init_kv_cache(cfg, batch, capacity, cfg.torch_dtype,
                             device=device)
          for _ in range(cfg.n_layers)]
    memory = torch.zeros((batch, memory_len, cfg.d_model),
                         dtype=cfg.torch_dtype, device=device)
    return EncDecCache(kv=kv, memory=memory)


class EncDec(nn.Module):
    """Encoder-decoder over a params tree from :func:`init_params` (or from
    :func:`repro_torch.convert.model_params_from_numpy`)."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        _require_encdec(cfg)
        self.cfg = cfg
        self.encoder = nn.ModuleList(ParamTree(b) for b in params["encoder"])
        self.decoder = nn.ModuleList(ParamTree(b) for b in params["decoder"])
        self.embed = ParamTree(params["embed"])
        self.enc_norm = ParamTree(params["enc_norm"])
        self.final_norm = ParamTree(params["final_norm"])
        self.lm_head = ParamTree(params["lm_head"])

    def _logits(self, x):
        return rms_norm(x, self.final_norm["scale"]) @ self.lm_head["w"]

    def encode(self, frames, *, window: int = 0, use_flash: bool = False):
        """frames: (B, S, d_model) precomputed frontend embeddings ->
        the memory (B, S, d_model)."""
        x = frames.to(self.cfg.torch_dtype)
        body = maybe_checkpoint(enc_block, self.cfg)
        for blk in self.encoder:
            x = body(blk.tensors(), x, self.cfg, window=window,
                     use_flash=use_flash)
        return rms_norm(x, self.enc_norm["scale"])

    def forward_train(self, batch: dict, *, window: int = 0, memory=None,
                      use_flash: bool | None = None):
        """batch: {"frames": (B, S, d), "tokens": (B, L)} -> (decoder
        logits, aux); ``memory`` given skips the encoder (``frames`` then
        unused); ``window`` is the encoder's; ``use_flash`` None chooses
        the decoder self-attention's route (see the module docstring)."""
        if memory is None:
            memory = self.encode(batch["frames"], window=window,
                                 use_flash=bool(use_flash))
        x = embed(self.embed, batch["tokens"]).to(self.cfg.torch_dtype)
        body = maybe_checkpoint(dec_block_train, self.cfg)
        for blk in self.decoder:
            x = body(blk.tensors(), x, memory, self.cfg, use_flash=use_flash)
        return self._logits(x), {"moe_aux": 0.0}

    forward = forward_train

    def init_decode_cache(self, batch: int, capacity: int,
                          memory_len: int = 0) -> EncDecCache:
        return init_decode_cache(self.cfg, batch, capacity, memory_len,
                                 device=self.embed["table"].device)

    def forward_decode(self, batch: dict, cache: EncDecCache):
        """One decoder token against the cached self-attention KV and the
        fixed memory.  batch: {"tokens": (B, 1)}."""
        x = embed(self.embed, batch["tokens"]).to(self.cfg.torch_dtype)
        kv = []
        for blk, layer_kv in zip(self.decoder, cache.kv):
            x, c = dec_block_decode(blk, x, cache.memory, layer_kv, self.cfg)
            kv.append(c)
        return self._logits(x), EncDecCache(kv=kv, memory=cache.memory)
