"""Plain PyTorch oracle for flash attention (causal + sliding window, GQA).

Port of ``repro/kernels/flash_attention/ref.py``.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Lq, H, D); k, v: (B, Lk, KV, D); H % KV == 0.

    window > 0 restricts lookback to [i - window + 1, i] (causal SW).
    """
    B, Lq, H, D = q.shape
    Lk, KV = k.shape[1], k.shape[2]
    group = H // KV
    qg = q.reshape(B, Lq, KV, group, D)
    scores = torch.einsum("bikgd,bjkd->bkgij", qg, k).to(torch.float32)
    scores = scores / torch.sqrt(torch.tensor(D, dtype=torch.float32))
    i = torch.arange(Lq, device=q.device)[:, None]
    j = torch.arange(Lk, device=q.device)[None, :]
    mask = torch.ones((Lq, Lk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (j <= i)
        if window > 0:
            mask = mask & (j > i - window)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgij,bjkd->bikgd", probs, v)
    return out.reshape(B, Lq, H, D)
