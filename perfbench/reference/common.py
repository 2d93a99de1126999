"""Plain float32 building blocks of the reference models.

Nothing here imports the program under test.  Every product goes through a
:class:`Precision`, so the same model code computes the reference (float32
operands, TF32 off) and the benchmark's control: the reference with each
product's operands rounded to fp8 (e4m3, one scale a tensor), the step
below the configuration's bf16 that a later change might take.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F32 = torch.float32
FP8_MAX = 448.0     # largest finite float8_e4m3fn


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` through float8 e4m3 with one scale for the tensor (amax to the
    format's largest value), back in float32.  Gradients pass unchanged."""
    amax = t.detach().abs().amax().clamp_min(1e-30)
    scale = amax / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(F32) * scale
    return t + (q - t.detach())


class Precision:
    """How the reference's products are computed: ``"fp32"`` (the
    reference) or ``"fp8"`` (the control)."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"precision {kind!r}: fp32 | fp8")
        self.kind = kind

    def _q(self, t):
        return fp8_round(t) if self.kind == "fp8" else t

    def mm(self, a, b):
        return self._q(a) @ self._q(b)

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self._q(a), self._q(b))


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for matmuls and cuDNN inside the block."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def rms(x, w, eps):
    """RMS norm with a zero-centred scale: x / rms(x) * (1 + w)."""
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * (1.0 + w)


def rope(x, theta):
    """Rotary embedding on (B, L, H, D): the two halves of D rotated by
    position / theta^(2i / D)."""
    L, D = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=F32, device=x.device) / D))
    ang = torch.arange(L, dtype=F32, device=x.device)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    a, b = x[..., : D // 2], x[..., D // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def causal_attention(q, k, v, prec: Precision):
    """Softmax attention under the causal mask.  q: (B, L, H, D); k, v:
    (B, L, KV, D) shared by H / KV consecutive query heads."""
    B, L, H, D = q.shape
    rep = H // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = prec.einsum("blhd,bshd->bhls", q, k) / math.sqrt(D)
    keep = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return prec.einsum("bhls,bshd->blhd", p, v)


def swiglu(x, wg, wu, wd, prec: Precision):
    return prec.mm(F.silu(prec.mm(x, wg)) * prec.mm(x, wu), wd)


def remat(fn, *args):
    """``fn(*args)`` recomputed in the backward pass when grad is on."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def lm_loss(h, norm_w, head_w, labels, eps, prec: Precision, rows: int = 1024):
    """Mean token cross-entropy of ``rms(h) @ head_w`` against ``labels``,
    over blocks of ``rows`` tokens (each recomputed in the backward pass),
    so the (tokens, vocabulary) logits never exist whole."""
    x = h.reshape(-1, h.shape[-1])
    y = labels.reshape(-1).long()

    def block(xb, yb):
        logits = prec.mm(rms(xb, norm_w, eps), head_w)
        return torch.sum(torch.logsumexp(logits, -1)
                         - logits.gather(1, yb[:, None])[:, 0])

    total = sum(remat(block, x[i:i + rows], y[i:i + rows])
                for i in range(0, x.shape[0], rows))
    return total / x.shape[0]
