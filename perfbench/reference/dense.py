"""Plain float32 reference of the dense decoder family (qwen3-1.7b).

Pre-norm blocks: grouped-query attention with qk-norm and RoPE over the
whole causal sequence, then a SwiGLU MLP; final norm, the LM head tied to
the embedding table (logits over its padded rows), mean token
cross-entropy.  Leaves are named as the
benchmark names them (``blocks.<i>.attn.wq``, ...), which is also how the
program under test names its parameters.
"""
from __future__ import annotations

import math

from perfbench.reference.common import (
    Precision,
    causal_attention,
    lm_loss,
    remat,
    rms,
    rope,
    swiglu,
)


def leaf_specs(m: dict) -> list[tuple]:
    """(name, shape, init, scale) of every leaf, in the program's order;
    init is "normal" (scale x N(0, 1)) or "zeros"."""
    d, H, KV, hd, ff = (m["d_model"], m["n_heads"], m["n_kv_heads"],
                        m["head_dim"], m["d_ff"])
    V = m["vocab_padded"]
    fan = lambda n: 1.0 / math.sqrt(n)
    out = []
    for i in range(m["n_layers"]):
        p = f"blocks.{i}."
        out += [(p + "ln1.scale", (d,), "zeros", 0.0),
                (p + "attn.wq", (d, H * hd), "normal", fan(d)),
                (p + "attn.wk", (d, KV * hd), "normal", fan(d)),
                (p + "attn.wv", (d, KV * hd), "normal", fan(d)),
                (p + "attn.wo", (H * hd, d), "normal", fan(H * hd))]
        if m["qk_norm"]:
            out += [(p + "attn.q_norm", (hd,), "zeros", 0.0),
                    (p + "attn.k_norm", (hd,), "zeros", 0.0)]
        out += [(p + "ln2.scale", (d,), "zeros", 0.0),
                (p + "mlp.w_gate", (d, ff), "normal", fan(d)),
                (p + "mlp.w_up", (d, ff), "normal", fan(d)),
                (p + "mlp.w_down", (ff, d), "normal", fan(ff))]
    out += [("embed.table", (V, d), "normal", 0.02),
            ("final_norm.scale", (d,), "zeros", 0.0)]
    return out


def _block(h, ln1, wq, wk, wv, wo, qn, kn, ln2, wg, wu, wd, m, prec):
    B, L, _ = h.shape
    H, KV, hd, eps = m["n_heads"], m["n_kv_heads"], m["head_dim"], m["rms_eps"]
    a = rms(h, ln1, eps)
    q = prec.mm(a, wq).reshape(B, L, H, hd)
    k = prec.mm(a, wk).reshape(B, L, KV, hd)
    v = prec.mm(a, wv).reshape(B, L, KV, hd)
    if qn is not None:
        q, k = rms(q, qn, eps), rms(k, kn, eps)
    q, k = rope(q, m["rope_theta"]), rope(k, m["rope_theta"])
    o = causal_attention(q, k, v, prec).reshape(B, L, H * hd)
    h = h + prec.mm(o, wo)
    return h + swiglu(rms(h, ln2, eps), wg, wu, wd, prec)


def loss(params: dict, tokens, labels, m: dict, prec: Precision | None = None):
    """Mean token cross-entropy of the float32 ``params`` on (B, L)
    ``tokens`` against ``labels``; each block recomputed in the backward."""
    prec = prec or Precision()
    h = params["embed.table"][tokens.long()]
    for i in range(m["n_layers"]):
        p = f"blocks.{i}."
        g = lambda n: params.get(p + n)
        h = remat(lambda *a: _block(*a, m, prec), h, g("ln1.scale"),
                  g("attn.wq"), g("attn.wk"), g("attn.wv"), g("attn.wo"),
                  g("attn.q_norm"), g("attn.k_norm"), g("ln2.scale"),
                  g("mlp.w_gate"), g("mlp.w_up"), g("mlp.w_down"))
    return lm_loss(h, params["final_norm.scale"], params["embed.table"].t(),
                   labels, m["rms_eps"], prec)

