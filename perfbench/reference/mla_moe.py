"""Plain float32 reference of the ``mla_moe`` family (DeepSeek-V2-Lite's
share of one chip).

Pre-norm blocks: multi-head latent attention (q from ``wq``; the
compressed KV ``c`` and one shared RoPE key head from ``wkv_a``; each
head's no-RoPE key and value from ``rms(c) wkv_b``; YaRN RoPE on the RoPE
parts; the causal softmax of the scores times ``mscale^2 / sqrt(D_qk)``),
then a dense SwiGLU in the first ``first_k_dense`` layers and DeepSeekMoE
after: the router's fp32 softmax over all its experts, greedy top-k, the
weights as they are times ``routed_scaling_factor``; the held experts'
SwiGLUs (``experts_held`` from ``expert_offset``) on the rows routed to
them, expert by expert, none dropped; the shared experts' SwiGLU on every
token; each layer's sequence-wise balance loss (``seq_aux``).  Final norm,
the untied head over the vocabulary slice, mean token cross-entropy.
RoPE on halves and zero-centred norm scales, as the program (the
configuration's ``departures``).  Nothing here imports the program.
Leaves are named as the program names its parameters.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.common import F32, Precision, lm_loss, remat, rms


def leaf_specs(m: dict) -> list[tuple]:
    """(name, shape, init, scale) of every leaf, in the program's order;
    init is "normal" (scale x N(0, 1)) or "zeros"."""
    d, H, r = m["d_model"], m["n_heads"], m["kv_lora_rank"]
    dn, dr, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    ff, n, E = m["moe_d_ff"], m["experts_held"], m["n_routed_experts"]
    sff = m["n_shared_experts"] * ff
    fan = lambda k: 1.0 / math.sqrt(k)
    out = []
    for i in range(m["n_layers"]):
        p = f"blocks.{i}."
        out += [(p + "ln1.scale", (d,), "zeros", 0.0),
                (p + "attn.wq", (d, H * (dn + dr)), "normal", fan(d)),
                (p + "attn.wkv_a", (d, r + dr), "normal", fan(d)),
                (p + "attn.kv_norm", (r,), "zeros", 0.0),
                (p + "attn.wkv_b", (r, H * (dn + dv)), "normal", fan(r)),
                (p + "attn.wo", (H * dv, d), "normal", fan(H * dv)),
                (p + "ln2.scale", (d,), "zeros", 0.0)]
        if i < m["first_k_dense"]:
            out += [(p + "mlp.w_gate", (d, m["d_ff"]), "normal", fan(d)),
                    (p + "mlp.w_up", (d, m["d_ff"]), "normal", fan(d)),
                    (p + "mlp.w_down", (m["d_ff"], d), "normal", fan(m["d_ff"]))]
        else:
            out += [(p + "moe.router", (d, E), "normal", fan(d)),
                    (p + "moe.w_gate", (n, d, ff), "normal", fan(d)),
                    (p + "moe.w_up", (n, d, ff), "normal", fan(d)),
                    (p + "moe.w_down", (n, ff, d), "normal", fan(ff)),
                    (p + "moe.shared.w_gate", (d, sff), "normal", fan(d)),
                    (p + "moe.shared.w_up", (d, sff), "normal", fan(d)),
                    (p + "moe.shared.w_down", (sff, d), "normal", fan(sff))]
    V = m["vocab_padded"]
    out += [("embed.table", (V, d), "normal", 0.02),
            ("final_norm.scale", (d,), "zeros", 0.0),
            ("lm_head.w", (d, V), "normal", 0.02)]
    return out


def _mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(m: dict, device) -> torch.Tensor:
    """YaRN's inverse frequencies over the RoPE dims (DeepSeek-V2's
    ``DeepseekV2YarnRotaryEmbedding``)."""
    y, dim, base = m["yarn"], m["qk_rope_head_dim"], m["rope_theta"]

    def corr(rot):
        return (dim * math.log(y["original_max_position_embeddings"] / (rot * 2 * math.pi))
                / (2 * math.log(base)))
    low = max(math.floor(corr(y["beta_fast"])), 0)
    high = min(math.ceil(corr(y["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    pw = base ** (torch.arange(0, dim, 2, dtype=F32, device=device) / dim)
    extra, inter = 1.0 / pw, 1.0 / (y["factor"] * pw)
    ramp = torch.clamp((torch.arange(dim // 2, dtype=F32, device=device) - low)
                       / (high - low), 0, 1)
    return inter * ramp + extra * (1 - ramp)


def softmax_scale(m: dict) -> float:
    ms = _mscale(m["yarn"]["factor"], m["yarn"]["mscale_all_dim"])
    return ms * ms / math.sqrt(m["qk_nope_head_dim"] + m["qk_rope_head_dim"])


def _rope(x, inv):
    L, D = x.shape[1], x.shape[-1]
    ang = torch.arange(L, dtype=F32, device=x.device)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    a, b = x[..., : D // 2], x[..., D // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _mla(h, wq, wkv_a, kv_norm, wkv_b, wo, m, prec):
    B, L, _ = h.shape
    H, r, eps = m["n_heads"], m["kv_lora_rank"], m["rms_eps"]
    dn, dr, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    inv = yarn_inv_freq(m, h.device)
    q = prec.mm(h, wq).reshape(B, L, H, dn + dr)
    ckv = prec.mm(h, wkv_a)
    kv = prec.mm(rms(ckv[..., :r], kv_norm, eps), wkv_b).reshape(B, L, H, dn + dv)
    q = torch.cat([q[..., :dn], _rope(q[..., dn:], inv)], dim=-1)
    k = torch.cat([kv[..., :dn], _rope(ckv[..., None, r:], inv).expand(B, L, H, dr)], dim=-1)
    o = _causal_attention(q, k, kv[..., dn:], softmax_scale(m), prec)
    return prec.mm(o.reshape(B, L, H * dv), wo)


def _causal_attention(q, k, v, scale, prec, rows: int = 1024):
    """Softmax attention under the causal mask, ``rows`` queries at a time
    against the keys up to the block's last (the rest are masked: computing
    them would add nothing but time).  q, k: (B, L, H, D); v: (B, L, H, DV)."""
    L = q.shape[1]
    out = []
    for i in range(0, L, rows):
        j = min(i + rows, L)
        s = prec.einsum("blhd,bshd->bhls", q[:, i:j], k[:, :j]) * scale
        keep = torch.ones(j - i, j, dtype=torch.bool, device=q.device).tril(i)
        p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
        out.append(prec.einsum("bhls,bshd->blhd", p, v[:, :j]))
    return torch.cat(out, dim=1)


def _swiglu(x, wg, wu, wd, prec):
    return prec.mm(F.silu(prec.mm(x, wg)) * prec.mm(x, wu), wd)


def _moe(a, router, wg, wu, wd, sg, su, sd, m, prec):
    """(routed part of the held experts + the shared experts, seq_aux)."""
    B, L, d = a.shape
    E, K = m["n_routed_experts"], m["experts_per_token"]
    xt = a.reshape(B * L, d)
    probs = torch.softmax(prec.mm(xt, router), dim=-1)
    w, idx = torch.topk(probs, K, dim=-1)
    if m["norm_topk_prob"]:
        w = w / w.sum(-1, keepdim=True)
    w = w * m["routed_scaling_factor"]
    out = torch.zeros_like(xt)
    for g in range(m["experts_held"]):
        tok, slot = torch.nonzero(idx == m["expert_offset"] + g, as_tuple=True)
        if tok.numel():
            y = _swiglu(xt[tok], wg[g], wu[g], wd[g], prec)
            out = out.index_add(0, tok, y * w[tok, slot][:, None])
    counts = torch.zeros(B, E, device=a.device).scatter_add(
        1, idx.reshape(B, L * K), torch.ones(B, L * K, device=a.device))
    aux = ((counts / (L * K / E)) * probs.reshape(B, L, E).mean(1)).sum(1).mean()
    return out.reshape(B, L, d) + _swiglu(a, sg, su, sd, prec), aux


def _block(h, ln1, wq, wkv_a, kv_norm, wkv_b, wo, ln2, w1, w2, w3, router,
           sg, su, sd, m, prec):
    eps = m["rms_eps"]
    h = h + _mla(rms(h, ln1, eps), wq, wkv_a, kv_norm, wkv_b, wo, m, prec)
    a = rms(h, ln2, eps)
    if router is None:
        return h + _swiglu(a, w1, w2, w3, prec), h.new_zeros(())
    out, aux = _moe(a, router, w1, w2, w3, sg, su, sd, m, prec)
    return h + out, aux


def loss(params: dict, tokens, labels, m: dict, prec: Precision | None = None):
    """Mean token cross-entropy of the float32 ``params`` on (B, L)
    ``tokens`` against ``labels``, plus alpha times the MoE layers' summed
    balance loss as a term of value 0 (``aux - aux.detach()``): the value
    is the cross-entropy, as the program records it (its ``aux["ce"]``),
    and the gradient is the whole loss's.  Each block is recomputed in the
    backward."""
    prec = prec or Precision()
    h = params["embed.table"][tokens.long()]
    aux = 0.0
    for i in range(m["n_layers"]):
        p = f"blocks.{i}."
        g = lambda n: params.get(p + n)
        ffn = ((g("mlp.w_gate"), g("mlp.w_up"), g("mlp.w_down"), None, None, None, None)
               if i < m["first_k_dense"] else
               (g("moe.w_gate"), g("moe.w_up"), g("moe.w_down"), g("moe.router"),
                g("moe.shared.w_gate"), g("moe.shared.w_up"), g("moe.shared.w_down")))
        h, a = remat(lambda *t: _block(*t, m, prec), h, g("ln1.scale"),
                     g("attn.wq"), g("attn.wkv_a"), g("attn.kv_norm"),
                     g("attn.wkv_b"), g("attn.wo"), g("ln2.scale"), *ffn)
        aux = aux + a
    ce = lm_loss(h, params["final_norm.scale"], params["lm_head.w"], labels,
                 m["rms_eps"], prec)
    return ce + m["aux_alpha"] * (aux - aux.detach())
