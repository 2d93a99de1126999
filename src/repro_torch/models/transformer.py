"""Decoder-only transformer backbone: the dense, MoE and VLM families (port
of ``repro/models/transformer.py``).

The reference stacks parameters over layers and scans them; the port keeps
one :class:`~repro_torch.models.common.ParamTree` per layer in an
``nn.ModuleList`` and loops over them eagerly.  Parameter paths match the
reference's (``blocks.<i>.attn.wq`` for layer i of the stacked
``blocks/attn/wq``), so :mod:`repro_torch.convert` carries weights across
one leaf at a time.  With ``cfg.remat`` a training forward checkpoints
each block (:func:`~repro_torch.models.common.maybe_checkpoint`, the
reference's per-layer ``jax.checkpoint``); serving runs without grad and
never recomputes.  A MoE block holds ``moe`` (:func:`~repro_torch.models.
mlp.moe`) where a dense one holds ``mlp``, and the forward returns the
mean of its router losses over the layers as ``moe_aux``.  The ``mla_moe``
family (DeepSeek-V2) chooses a block kind per layer: multi-head latent
attention (:func:`~repro_torch.models.attention.mla_train`) in every
layer, a dense SwiGLU of ``d_ff`` in the first ``first_k_dense`` layers and
a DeepSeekMoE expert share (:func:`~repro_torch.models.mlp.expert_share`)
after them, and its ``moe_aux`` is the sum of the MoE layers' balance
losses, as DeepSeek adds each layer's; it trains only (prefill and decode
through a latent cache are not ported and raise).  A VLM prepends
the batch's ``vision_embeds`` (B, n_vision_tokens, d) to the token
embeddings in the training forward and in prefill; decode feeds tokens.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch._device import resolve_device
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
from repro_torch.models.mlp import (
    expert_share,
    init_expert_share,
    init_mlp,
    init_moe,
    mlp,
    moe,
)
from repro_torch.obs import trace

#: the families this backbone runs
FAMILIES = ("dense", "moe", "vlm", "mla_moe")


def _require_transformer(cfg: ModelConfig):
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r} is not a transformer "
                         f"family {FAMILIES}")


# ---------------------------------------------------------------------------
# One decoder block
# ---------------------------------------------------------------------------

def init_block(ini: Initializer, cfg: ModelConfig, i: int = 0):
    """Layer ``i``'s parameters (its kind depends on ``i`` in the
    ``mla_moe`` family)."""
    mla = cfg.family == "mla_moe"
    p = {
        "ln1": init_rms_norm(ini, cfg.d_model),
        "attn": (attn.init_mla if mla else attn.init_attention)(ini, cfg),
        "ln2": init_rms_norm(ini, cfg.d_model),
    }
    if mla and cfg.is_moe_layer(i):
        p["moe"] = init_expert_share(ini, cfg)
    elif cfg.family == "moe":
        p["moe"] = init_moe(ini, cfg)
    else:
        p["mlp"] = init_mlp(ini, cfg)
    return p


def _ffn(params, x, cfg: ModelConfig):
    """The block's feed-forward half: (out, router aux loss); the kind
    is read from the block's parameters."""
    normed = rms_norm(x, params["ln2"]["scale"])
    if "mlp" in params:
        return trace.layer("mlp", mlp, params["mlp"], normed, cfg), 0.0
    if cfg.family == "mla_moe":
        return expert_share(params["moe"], normed, cfg)
    return moe(params["moe"], normed, cfg)


def block_train(params, x, cfg: ModelConfig, *, window: int = 0,
                use_flash: bool | None = None):
    """Returns (x, router aux loss: 0.0 for a dense block).  ``use_flash``
    as :func:`~repro_torch.models.attention.attention_train` takes it
    (None: the route is chosen there)."""
    fn = attn.mla_train if cfg.family == "mla_moe" else attn.attention_train
    h = trace.layer("attention", fn, params["attn"],
                    rms_norm(x, params["ln1"]["scale"]), cfg, window=window,
                    use_flash=use_flash)
    x = x + h
    out, aux = _ffn(params, x, cfg)
    return x + out, aux


def block_decode(params, x, cache: attn.KVCache, cfg: ModelConfig):
    h, cache = attn.attention_decode(
        params["attn"], rms_norm(x, params["ln1"]["scale"]), cache, cfg)
    x = x + h
    return x + _ffn(params, x, cfg)[0], cache


def block_prefill(params, x, cfg: ModelConfig, capacity: int):
    h, cache = attn.attention_prefill(
        params["attn"], rms_norm(x, params["ln1"]["scale"]), cfg, capacity)
    x = x + h
    return x + _ffn(params, x, cfg)[0], cache


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def initializer(cfg: ModelConfig, seed: int, device) -> Initializer:
    """An :class:`Initializer` of ``cfg``'s dtype drawing from a
    ``torch.Generator`` on ``device`` (default the card, through
    ``resolve_device``) seeded with ``seed``; on ``"meta"`` it gives the
    shapes without memory."""
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else torch.Generator(
        device=dev).manual_seed(seed)
    return Initializer(gen, cfg.torch_dtype, device=dev)


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """Returns (params, axes): nested dicts with ``blocks`` a per-layer list
    (each layer's leaves carry their own axes, without the reference's
    stacked ``layers`` axis).

    Weights are drawn from a ``torch.Generator`` on ``device`` seeded with
    ``seed`` (:func:`initializer`).
    """
    _require_transformer(cfg)
    ini = initializer(cfg, seed, device)
    V = pad_vocab(cfg.vocab_size)
    tree = {"blocks": [init_block(ini, cfg, i) for i in range(cfg.n_layers)],
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
    """Dense / MoE / VLM decoder over a params tree from :func:`init_params`
    (or from :func:`repro_torch.convert.model_params_from_numpy`)."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        _require_transformer(cfg)
        self.cfg = cfg
        self.blocks = nn.ModuleList(ParamTree(b) for b in params["blocks"])
        self.embed = ParamTree(params["embed"])
        self.final_norm = ParamTree(params["final_norm"])
        if not cfg.tie_embeddings:
            self.lm_head = ParamTree(params["lm_head"])

    def _embed(self, tokens):
        return embed(self.embed, tokens).to(self.cfg.torch_dtype)

    def _embed_inputs(self, batch: dict):
        """tokens (+ a VLM's vision embeds prepended) -> (B, L, d)."""
        x = self._embed(batch["tokens"])
        if self.cfg.family == "vlm" and "vision_embeds" in batch:
            vis = batch["vision_embeds"].to(self.cfg.torch_dtype)
            x = torch.cat([vis, x], dim=1)
        return x

    def _logits(self, x):
        x = rms_norm(x, self.final_norm["scale"])
        if self.cfg.tie_embeddings:
            return torch.einsum("bld,vd->blv", x, self.embed["table"])
        return x @ self.lm_head["w"]

    def forward_train(self, batch: dict, *, window: int = 0,
                      use_flash: bool | None = None):
        """Full causal forward.  Returns (logits, aux_losses dict):
        ``moe_aux`` is the router loss's mean over layers (0.0 when dense)."""
        x = self._embed_inputs(batch)
        body = maybe_checkpoint(block_train, self.cfg)
        moe_aux = 0.0
        for blk in self.blocks:
            x, a = trace.layer("block", body, blk.tensors(), x, self.cfg,
                               window=window, use_flash=use_flash)
            moe_aux = moe_aux + a
        if self.cfg.family != "mla_moe":
            moe_aux = moe_aux / max(self.cfg.n_layers, 1)
        return trace.layer("loss_head", self._logits, x), {"moe_aux": moe_aux}

    forward = forward_train

    def init_decode_cache(self, batch: int, capacity: int):
        return init_decode_cache(self.cfg, batch, capacity,
                                 device=self.embed["table"].device)

    def _serves(self):
        if self.cfg.family == "mla_moe":
            raise NotImplementedError(
                f"{self.cfg.name}: serving the mla_moe family (prefill and "
                "decode through a latent KV cache) is not ported; it trains")

    def forward_decode(self, batch: dict, caches):
        """One-token decode. batch: {"tokens": (B, 1)}; caches: per layer."""
        self._serves()
        x = self._embed(batch["tokens"])
        new = []
        for blk, cache in zip(self.blocks, caches):
            x, c = block_decode(blk, x, cache, self.cfg)
            new.append(c)
        return self._logits(x), new

    def forward_prefill(self, batch: dict, capacity: int):
        """Full forward + cache materialisation; logits of the last position
        only (the final norm is per row, so it is applied to that row)."""
        self._serves()
        x = self._embed_inputs(batch)
        caches = []
        for blk in self.blocks:
            x, c = block_prefill(blk, x, self.cfg, capacity)
            caches.append(c)
        return self._logits(x[:, -1:, :]), caches
