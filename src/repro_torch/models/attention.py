"""Grouped-query attention with RoPE, optional qk-norm / QKV bias / sliding
window, plus the decode path against a (possibly ring-buffered) KV cache.

Port of ``repro/models/attention.py``.  Prefill computes its ``L x L``
causal (or sliding-window) attention through the port's flash kernel
(:func:`repro_torch.kernels.flash_attention.kernel.flash_attention`): the
same function as the reference's ``_sdpa`` under ``causal_mask``, computed
blockwise.  That holds for every decoder family's prefill: dense, MoE and
VLM blocks, and the hybrid's shared block (the SSM family has no
attention).  The bf16 kernel runs D 64, 80, 96, 128 and 256 at their
true width (zamba2's 80 and phi-3's 96 included); a head dim that the
kernel of the dtype is not instantiated for (``HEAD_DIMS``: fp32 32, 80,
96; bf16 32) goes through the kernel's head-dim route, zero padding along
D.  ``attention_train`` keeps the reference's
``use_flash=False`` default.  Decode attention (one query against the
cache) stays plain torch ops, as the reference computes it outside any
kernel.

The encoder-decoder family adds two non-causal uses of the same kernel:
:func:`attention_bidir` (the encoder's self-attention, ``Lq = Lk``) and
:func:`cross_attention` (decoder queries against the encoder's memory,
``Lq != Lk``; memory and queries get no RoPE), both through the kernel
with ``causal=False`` when ``use_flash`` is set: the reference's ``_sdpa``
with ``mask=None``.  An encoder window ``0 < window < L`` masks
``|i - j| < window``, a symmetric band that neither the reference's
Pallas kernel nor the port's computes, so that call computes ``_sdpa``
under the mask on every device, as the reference does: a dispatch on
what the kernel computes, not a fallback on failure, counted in
``DISPATCH_COUNTS["bidir_window_sdpa"]``.  Every flash call goes through
this module's ``flash_attention`` name, which ``serve_drift`` swaps.
"""
from __future__ import annotations

import collections
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.models.common import Initializer, apply_rope, cast, rms_norm

NEG_INF = -1e30

#: calls that asked for the kernel but compute ``_sdpa`` because the kernel
#: does not compute their mask: "bidir_window_sdpa" counts encoder calls
#: under a symmetric window narrower than the sequence
DISPATCH_COUNTS: collections.Counter = collections.Counter()


def init_attention(ini: Initializer, cfg: ModelConfig):
    d, hd = cfg.d_model, cfg.hd
    H, KV = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": ini.normal((d, H * hd), ("embed", "qkv")),
        "wk": ini.normal((d, KV * hd), ("embed", "qkv")),
        "wv": ini.normal((d, KV * hd), ("embed", "qkv")),
        "wo": ini.normal((H * hd, d), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = ini.zeros((H * hd,), ("qkv",))
        p["bk"] = ini.zeros((KV * hd,), ("qkv",))
        p["bv"] = ini.zeros((KV * hd,), ("qkv",))
    if cfg.qk_norm:
        p["q_norm"] = ini.zeros((hd,), (None,))
        p["k_norm"] = ini.zeros((hd,), (None,))
    return p


def _project_qkv(params, x, cfg: ModelConfig, positions):
    B, L, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, L, H, hd)
    k = k.reshape(B, L, KV, hd)
    v = v.reshape(B, L, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, cfg: ModelConfig):
    """q: (B,L,H,hd) k/v: (B,S,KV,hd); GQA via head grouping."""
    B, L, H, hd = q.shape
    KV = k.shape[2]
    group = H // KV
    qg = q.reshape(B, L, KV, group, hd)
    scores = cast(torch.einsum("blkgh,bskh->bklgs", qg, k), torch.float32)
    scores = scores / torch.sqrt(torch.tensor(hd, dtype=torch.float32))
    if mask is not None:
        scores = torch.where(mask[:, None, :, None, :], scores, NEG_INF)
    probs = cast(torch.softmax(scores, dim=-1), v.dtype)
    out = torch.einsum("bklgs,bskh->blkgh", probs, v)
    return out.reshape(B, L, H, hd)


def causal_mask(L: int, window: int = 0, device=None):
    """(L, L) True = attend.  window>0 limits lookback (sliding window)."""
    i = torch.arange(L, device=device)[:, None]
    j = torch.arange(L, device=device)[None, :]
    m = j <= i
    if window > 0:
        m = m & (j > i - window)
    return m


def attention_train(params, x, cfg: ModelConfig, *, window: int = 0,
                    use_flash: bool = False):
    """Full-sequence causal attention. x: (B, L, d)."""
    B, L, _ = x.shape
    positions = torch.arange(L, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, cfg, positions)
    w = window or cfg.sliding_window
    if use_flash:
        out = flash_attention(q, k, v, causal=True, window=w)
    else:
        mask = causal_mask(L, w, device=x.device)[None]
        out = _sdpa(q, k, v, mask, cfg)
    out = out.reshape(B, L, cfg.n_heads * cfg.hd)
    return out @ params["wo"]


def attention_bidir(params, x, cfg: ModelConfig, *, window: int = 0,
                    use_flash: bool = False):
    """Bidirectional (encoder) attention; optional symmetric window
    ``|i - j| < window``.  x: (B, L, d).

    With ``use_flash`` and no band to mask (``window == 0`` or ``window >=
    L``) it runs the flash kernel, non-causal; a narrower window computes
    ``_sdpa`` under its mask (see the module docstring).
    """
    B, L, _ = x.shape
    positions = torch.arange(L, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, cfg, positions)
    banded = 0 < window < L
    if use_flash and not banded:
        out = flash_attention(q, k, v, causal=False)
    else:
        if use_flash:
            DISPATCH_COUNTS["bidir_window_sdpa"] += 1
        mask = None
        if window > 0:
            i = torch.arange(L, device=x.device)[:, None]
            j = torch.arange(L, device=x.device)[None, :]
            mask = (torch.abs(i - j) < window)[None]
        out = _sdpa(q, k, v, mask, cfg)
    out = out.reshape(B, L, cfg.n_heads * cfg.hd)
    return out @ params["wo"]


# ---------------------------------------------------------------------------
# Cross attention (enc-dec)
# ---------------------------------------------------------------------------

def init_cross_attention(ini: Initializer, cfg: ModelConfig):
    d, hd = cfg.d_model, cfg.hd
    H, KV = cfg.n_heads, cfg.n_kv_heads
    return {
        "wq": ini.normal((d, H * hd), ("embed", "qkv")),
        "wk": ini.normal((d, KV * hd), ("embed", "qkv")),
        "wv": ini.normal((d, KV * hd), ("embed", "qkv")),
        "wo": ini.normal((H * hd, d), ("heads", "embed")),
    }


def cross_attention(params, x, memory, cfg: ModelConfig, *,
                    use_flash: bool = False):
    """x: (B, L, d) queries; memory: (B, S, d) encoder output (no RoPE).

    The memory's keys and values are projected on every call, as the
    reference does (decode too).  ``use_flash`` runs the kernel,
    non-causal, with ``Lq = L`` against ``Lk = S``.
    """
    B, L, _ = x.shape
    S = memory.shape[1]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ params["wq"]).reshape(B, L, H, hd)
    k = (memory @ params["wk"]).reshape(B, S, KV, hd)
    v = (memory @ params["wv"]).reshape(B, S, KV, hd)
    if use_flash:
        out = flash_attention(q, k, v, causal=False)
    else:
        out = _sdpa(q, k, v, None, cfg)
    out = out.reshape(B, L, H * hd)
    return out @ params["wo"]


# ---------------------------------------------------------------------------
# Decode path with KV cache (optionally a sliding-window ring buffer)
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor      # (B, C, KV, hd)  C = cache capacity
    v: torch.Tensor      # (B, C, KV, hd)
    pos: int             # absolute position of the next token


def init_kv_cache(cfg: ModelConfig, batch: int, capacity: int, dtype,
                  device=None) -> KVCache:
    shape = (batch, capacity, cfg.n_kv_heads, cfg.hd)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device), pos=0)


def attention_decode(params, x, cache: KVCache, cfg: ModelConfig):
    """One-token decode.  x: (B, 1, d).  Ring-buffer write at pos % C.

    Works for both full caches (C >= seq_len) and sliding-window caches
    (C = window): the mask keeps only positions in (pos - C, pos].  The new
    key and value are written into ``cache.k`` / ``cache.v`` in place (the
    reference returns updated copies; in place saves a copy of every
    layer's cache per token), and the returned cache shares their storage.
    """
    B = x.shape[0]
    C = cache.k.shape[1]
    pos = cache.pos
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(params, x, cfg, positions)

    slot = pos % C
    cache.k[:, slot:slot + 1] = k_new
    cache.v[:, slot:slot + 1] = v_new

    # absolute position stored in each slot s: the newest write to s
    slots = torch.arange(C, device=x.device)
    abs_pos = pos - torch.remainder(pos - slots, C)   # in (pos-C, pos]
    mask = (abs_pos >= 0)[None, None, :].expand(B, 1, C)

    out = _sdpa(q, cache.k, cache.v, mask, cfg)
    out = out.reshape(B, 1, cfg.n_heads * cfg.hd)
    return out @ params["wo"], KVCache(k=cache.k, v=cache.v, pos=pos + 1)


def attention_prefill(params, x, cfg: ModelConfig, capacity: int):
    """Full forward that also materialises the cache for subsequent decode.

    The causal (sliding-window when ``cfg.sliding_window``) attention goes
    through the flash kernel.
    """
    B, L, _ = x.shape
    positions = torch.arange(L, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, cfg, positions)
    out = flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
    out = out.reshape(B, L, cfg.n_heads * cfg.hd)
    out = out @ params["wo"]

    C = capacity
    if C >= L:
        kc = k.new_zeros((B, C) + k.shape[2:])
        vc = v.new_zeros((B, C) + v.shape[2:])
        kc[:, :L] = k
        vc[:, :L] = v
    else:
        # keep the last C positions, ring-aligned so slot = pos % C
        start = L - C
        kc = torch.roll(k[:, start:], shifts=L % C, dims=1)
        vc = torch.roll(v[:, start:], shifts=L % C, dims=1)
    return out, KVCache(k=kc, v=vc, pos=L)
