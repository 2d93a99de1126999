"""Input specs for every (architecture x input-shape) combination, with
their logical-axes trees (port of ``repro/launch/specs.py``).

Nothing here allocates memory: a spec is a tensor on the ``meta`` device
(shape and dtype, no storage), and :func:`eval_shapes` runs a builder
under ``torch.device("meta")`` where the reference runs
``jax.eval_shape``.  The axes trees follow the port's caches: one
``KVCache`` / ``MambaCache`` a layer (a hybrid's Mamba caches a group and
a layer in it), so the reference's stacked ``layers`` / ``groups`` axis is
the list around them, and a cache's ``pos`` is a host integer (axes
``()``).  Logical axes are those of :mod:`repro_torch.launch.sharding`.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import INPUT_SHAPES, ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import hybrid as hybrid_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as transformer_mod
from repro_torch.models.mamba2 import MambaCache

DEC_TOKENS_TRAIN = 512          # enc-dec decoder length during training

META = torch.device("meta")


def S(shape, dtype) -> torch.Tensor:
    """A spec: a ``meta`` tensor of ``shape`` and ``dtype``."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def eval_shapes(fn, *args):
    """``fn(*args)`` with every tensor it makes on ``meta``."""
    with META:
        return fn(*args)


# ---------------------------------------------------------------------------
# Train batches: leaves (n_clients, per_client_batch, ...)
# ---------------------------------------------------------------------------

def train_batch_specs(cfg: ModelConfig, shape_name: str, n_clients: int):
    seq, global_batch, kind = INPUT_SHAPES[shape_name]
    assert kind == "train", shape_name
    B = max(global_batch // max(n_clients, 1), 1)
    n = max(n_clients, 1)
    i32 = torch.int32
    d = cfg.d_model
    if cfg.family == "vlm":
        L_text = seq - cfg.n_vision_tokens
        specs = {
            "tokens": S((n, B, L_text), i32),
            "labels": S((n, B, L_text), i32),
            "vision_embeds": S((n, B, cfg.n_vision_tokens, d),
                               cfg.torch_dtype),
        }
        axes = {
            "tokens": ("clients", "batch", "seq"),
            "labels": ("clients", "batch", "seq"),
            "vision_embeds": ("clients", "batch", "seq", "embed"),
        }
    elif cfg.family == "encdec":
        specs = {
            "frames": S((n, B, seq, d), cfg.torch_dtype),
            "tokens": S((n, B, DEC_TOKENS_TRAIN), i32),
            "labels": S((n, B, DEC_TOKENS_TRAIN), i32),
        }
        axes = {
            "frames": ("clients", "batch", "seq", "embed"),
            "tokens": ("clients", "batch", "seq"),
            "labels": ("clients", "batch", "seq"),
        }
    else:
        specs = {
            "tokens": S((n, B, seq), i32),
            "labels": S((n, B, seq), i32),
        }
        axes = {
            "tokens": ("clients", "batch", "seq"),
            "labels": ("clients", "batch", "seq"),
        }
    return specs, axes


# ---------------------------------------------------------------------------
# Serving specs (no client dim)
# ---------------------------------------------------------------------------

def prefill_specs(cfg: ModelConfig, shape_name: str):
    seq, batch, kind = INPUT_SHAPES[shape_name]
    assert kind == "prefill", shape_name
    i32 = torch.int32
    d = cfg.d_model
    if cfg.family == "vlm":
        specs = {
            "tokens": S((batch, seq - cfg.n_vision_tokens), i32),
            "vision_embeds": S((batch, cfg.n_vision_tokens, d),
                               cfg.torch_dtype),
        }
        axes = {
            "tokens": ("dbatch", "seq"),
            "vision_embeds": ("dbatch", "seq", "embed"),
        }
    elif cfg.family == "encdec":
        specs = {
            "frames": S((batch, seq, d), cfg.torch_dtype),
            "tokens": S((batch, DEC_TOKENS_TRAIN), i32),
        }
        axes = {
            "frames": ("dbatch", "seq", "embed"),
            "tokens": ("dbatch", "seq"),
        }
    else:
        specs = {"tokens": S((batch, seq), i32)}
        axes = {"tokens": ("dbatch", "seq")}
    return specs, axes


def decode_capacity(cfg: ModelConfig, shape_name: str) -> int:
    seq, _, kind = INPUT_SHAPES[shape_name]
    assert kind == "decode", shape_name
    if shape_name == "long_500k":
        # sub-quadratic mode: sliding-window ring buffer (or SSD state)
        return cfg.long_context_window or 8192
    if cfg.sliding_window:
        return min(seq, cfg.sliding_window)
    return seq


def _kv_axes():
    return attn_mod.KVCache(k=("dbatch", "cache", "kv", "hd"),
                            v=("dbatch", "cache", "kv", "hd"), pos=())


def _mamba_axes():
    return MambaCache(conv=("dbatch", None, "ssm_inner"),
                      ssd=("dbatch", None, "ssm_state", None))


def decode_cache_specs(cfg: ModelConfig, shape_name: str):
    """(cache of ``meta`` tensors, axes tree) for the serve step."""
    seq, batch, kind = INPUT_SHAPES[shape_name]
    assert kind == "decode", shape_name
    cap = decode_capacity(cfg, shape_name)
    fam = cfg.family

    if fam in ("dense", "moe", "vlm"):
        shapes = eval_shapes(transformer_mod.init_decode_cache, cfg, batch,
                             cap)
        return shapes, [_kv_axes() for _ in shapes]
    if fam == "ssm":
        shapes = eval_shapes(ssm_mod.init_decode_cache, cfg, batch)
        return shapes, [_mamba_axes() for _ in shapes]
    if fam == "hybrid":
        shapes = eval_shapes(hybrid_mod.init_decode_cache, cfg, batch, cap)
        axes = hybrid_mod.HybridCache(
            mamba=[[_mamba_axes() for _ in group] for group in shapes.mamba],
            kv=[_kv_axes() for _ in shapes.kv])
        return shapes, axes
    if fam == "encdec":
        # memory = encoder output over the full context length
        shapes = eval_shapes(encdec_mod.init_decode_cache, cfg, batch, 4096,
                             seq)
        axes = encdec_mod.EncDecCache(
            kv=[_kv_axes() for _ in shapes.kv],
            memory=("dbatch", "memseq", "embed"))
        return shapes, axes
    raise ValueError(fam)


def decode_token_specs(cfg: ModelConfig, shape_name: str):
    _, batch, kind = INPUT_SHAPES[shape_name]
    assert kind == "decode"
    return (
        {"tokens": S((batch, 1), torch.int32)},
        {"tokens": ("dbatch", None)},
    )
