"""Mamba2 / SSD (state-space duality) blocks [arXiv:2405.21060] (port of
``repro/models/mamba2.py``).

Selective SSM with scalar-per-head decay A, discretised as

    h_t = exp(dt_t A) h_{t-1} + dt_t * B_t x_t^T     (state: (N, P) per head)
    y_t = C_t h_t + D x_t

Training and prefill use the *chunked* SSD algorithm: quadratic
attention-like compute inside chunks of Q tokens plus a linear inter-chunk
recurrence (a loop over chunks, the reference's ``lax.scan``).  Decode is
the O(1) recurrence.  ngroups = 1 (B/C shared across heads), matching the
published 130M config.  The reference computes all of it as plain JAX
(no Pallas kernel), so the port computes it as plain PyTorch: the depthwise
causal convolution is ``F.conv1d`` with ``groups`` = channels, the SSD
contractions are ``torch.einsum``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Initializer, rms_norm


def init_mamba(ini: Initializer, cfg: ModelConfig):
    d = cfg.d_model
    di = cfg.ssm_inner
    H, N, W = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_conv_width
    conv_ch = di + 2 * N
    f32 = torch.float32
    return {
        # fused input projection: [z(di), x(di), B(N), C(N), dt(H)]
        "in_proj": ini.normal((d, 2 * di + 2 * N + H), ("embed", "ssm_inner")),
        "conv_w": ini.normal((W, conv_ch), (None, "ssm_inner"), scale=0.5),
        "conv_b": ini.zeros((conv_ch,), ("ssm_inner",)),
        "dt_bias": ini.const(
            torch.log(torch.expm1(torch.linspace(1e-3, 0.1, H, dtype=f32))),
            (None,)),
        "A_log": ini.const(torch.log(torch.linspace(1.0, 16.0, H, dtype=f32)),
                           (None,)),
        "D": ini.ones((H,), (None,)),
        "norm": ini.zeros((di,), ("ssm_inner",)),
        "out_proj": ini.normal((di, d), ("ssm_inner", "embed")),
    }


def _split_proj(cfg: ModelConfig, zxbcdt):
    di, N = cfg.ssm_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * N]
    dt = zxbcdt[..., 2 * di + 2 * N:]
    return z, xbc, dt


def _causal_conv_train(x, w, b):
    """Depthwise causal conv in fp32. x: (B, L, C), w: (W, C), b: (C,).

    Both libraries cross-correlate, so the ``(W, C)`` weight goes to
    ``conv1d`` as ``(C, 1, W)`` unflipped, after W - 1 zeros in front.
    """
    W, C = w.shape
    xp = F.pad(x.to(torch.float32).transpose(1, 2), (W - 1, 0))
    out = F.conv1d(xp, w.to(torch.float32).t().unsqueeze(1), groups=C)
    return (out.transpose(1, 2) + b).to(x.dtype)


def ssd_chunked(x, dt, A, b, c, chunk: int):
    """Chunked SSD scan.

    x: (B, L, H, P)   dt: (B, L, H)   A: (H,) (negative)
    b, c: (B, L, N)   (ngroups=1, shared across heads)
    Returns (y: (B, L, H, P), final_state: (B, H, N, P) fp32).
    ``L`` must be a multiple of ``chunk`` (the sequence is not padded).
    """
    B_, L, H, P = x.shape
    N = b.shape[-1]
    if L % chunk:
        raise ValueError(f"L={L} not divisible by chunk={chunk}")
    nc = L // chunk
    f32 = torch.float32

    xc = x.reshape(B_, nc, chunk, H, P).to(f32)
    dtc = dt.reshape(B_, nc, chunk, H).to(f32)
    bc = b.reshape(B_, nc, chunk, N).to(f32)
    cc = c.reshape(B_, nc, chunk, N).to(f32)

    la = dtc * A.to(f32)                              # log-decay per step
    cs = torch.cumsum(la, dim=2)                      # inclusive (B,nc,Q,H)

    # ---- intra-chunk (quadratic within chunk) ----
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]        # (B,nc,t,s,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    # mask *before* exp so no inf enters the graph (NaN-safe gradients)
    seg = torch.where(tri[None, None, :, :, None], seg, float("-inf"))
    decay = torch.exp(seg)
    cb = torch.einsum("bktn,bksn->bkts", cc, bc)             # (B,nc,t,s)
    scores = cb[..., None] * decay * dtc[:, :, None, :, :]   # dt at s
    y_intra = torch.einsum("bktsh,bkshp->bkthp", scores, xc)

    # ---- chunk boundary states ----
    rem = torch.exp(cs[:, :, -1:, :] - cs)                   # decay to chunk end
    wgt = dtc * rem                                          # (B,nc,Q,H)
    Sk = torch.einsum("bksn,bksh,bkshp->bkhnp", bc, wgt, xc)

    chunk_decay = torch.exp(cs[:, :, -1, :])                 # (B,nc,H)
    h = torch.zeros((B_, H, N, P), dtype=f32, device=x.device)
    h_prevs = []                                             # state entering chunk
    for k in range(nc):
        h_prevs.append(h)
        h = chunk_decay[:, k, :, None, None] * h + Sk[:, k]
    h_prevs = torch.stack(h_prevs, dim=1)                    # (B,nc,H,N,P)

    # ---- inter-chunk contribution ----
    c_dec = cc[:, :, :, None, :] * torch.exp(cs)[..., None]  # (B,nc,t,H,N)
    y_inter = torch.einsum("bkthn,bkhnp->bkthp", c_dec, h_prevs)

    y = (y_intra + y_inter).reshape(B_, L, H, P).to(x.dtype)
    return y, h


def ssd_decode_step(state, x, dt, A, b, c):
    """One-token recurrence.  state: (B,H,N,P); x: (B,H,P); dt: (B,H);
    b, c: (B, N).  Returns (y: (B,H,P), new_state)."""
    f32 = torch.float32
    a = torch.exp(dt.to(f32) * A.to(f32))                     # (B,H)
    outer = torch.einsum("bn,bh,bhp->bhnp", b.to(f32), dt.to(f32),
                         x.to(f32))
    new_state = a[:, :, None, None] * state + outer
    y = torch.einsum("bn,bhnp->bhp", c.to(f32), new_state)
    return y.to(x.dtype), new_state


class MambaCache(NamedTuple):
    conv: torch.Tensor    # (B, W-1, conv_channels): the last raw inputs
    ssd: torch.Tensor     # (B, H, N, P) fp32 state


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype,
                     device=None) -> MambaCache:
    conv_ch = cfg.ssm_inner + 2 * cfg.ssm_state
    return MambaCache(
        conv=torch.zeros((batch, cfg.ssm_conv_width - 1, conv_ch),
                         dtype=dtype, device=device),
        ssd=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state,
                         cfg.ssm_head_dim), dtype=torch.float32,
                        device=device))


def _gated_out(params, y, x, z, cfg: ModelConfig):
    """y + D x, gated by silu(z), normed, projected out (any leading dims)."""
    y = y + params["D"].to(y.dtype)[:, None] * x
    y = y.reshape(y.shape[:-2] + (cfg.ssm_inner,))
    y = rms_norm(y * F.silu(z), params["norm"])
    return y @ params["out_proj"]


def _ssm_inputs(params, xbc_conv, dt, cfg: ModelConfig):
    """The conv output split into x (heads), b, c; dt softplus'd and A."""
    di, N = cfg.ssm_inner, cfg.ssm_state
    x = xbc_conv[..., :di].reshape(xbc_conv.shape[:-1]
                                   + (cfg.ssm_heads, cfg.ssm_head_dim))
    b = xbc_conv[..., di:di + N]
    c = xbc_conv[..., di + N:]
    dt = F.softplus(dt.to(torch.float32)
                    + params["dt_bias"].to(torch.float32))
    A = -torch.exp(params["A_log"].to(torch.float32))
    return x, b, c, dt, A


def mamba_block(params, u, cfg: ModelConfig):
    """Full-sequence mamba2 block. u: (B, L, d) -> (y, final MambaCache)."""
    L = u.shape[1]
    z, xbc, dt = _split_proj(cfg, u @ params["in_proj"])
    xbc_conv = F.silu(_causal_conv_train(xbc, params["conv_w"],
                                         params["conv_b"]))
    x, b, c, dt, A = _ssm_inputs(params, xbc_conv, dt, cfg)
    y, h_final = ssd_chunked(x, dt, A, b, c, cfg.ssm_chunk)
    out = _gated_out(params, y, x, z, cfg)
    # conv cache = last W-1 raw xbc inputs (zeros in front when L < W-1)
    W = cfg.ssm_conv_width
    conv_cache = (xbc[:, L - (W - 1):, :] if L >= W - 1
                  else F.pad(xbc, (0, 0, W - 1 - L, 0)))
    return out, MambaCache(conv=conv_cache, ssd=h_final)


def mamba_decode(params, u, cache: MambaCache, cfg: ModelConfig):
    """One-token mamba2 step. u: (B, 1, d) -> (y: (B,1,d), new cache)."""
    z, xbc, dt = _split_proj(cfg, u[:, 0] @ params["in_proj"])

    # causal conv over (cached W-1 inputs, current input)
    hist = torch.cat([cache.conv, xbc[:, None, :]], dim=1)   # (B, W, C)
    f32 = torch.float32
    conv_out = torch.einsum("bwc,wc->bc", hist.to(f32),
                            params["conv_w"].to(f32)) \
        + params["conv_b"].to(f32)
    xbc_conv = F.silu(conv_out).to(u.dtype)

    x, b, c, dt, A = _ssm_inputs(params, xbc_conv, dt, cfg)
    y, new_ssd = ssd_decode_step(cache.ssd, x, dt, A, b, c)
    out = _gated_out(params, y, x, z, cfg)[:, None, :]
    new_conv = hist[:, 1:, :].to(cache.conv.dtype)
    return out, MambaCache(conv=new_conv, ssd=new_ssd)
