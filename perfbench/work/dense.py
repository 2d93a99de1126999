"""Training FLOPs of the dense decoder family (qwen3-1.7b), a token.

Every matrix product of the model counts 6 FLOPs a weight a token: 2
forward, 4 backward (input and weight gradients).  The LM head counts over
the published vocabulary (the program's padding rows are not the model's),
also where it is tied to the embedding; the input embedding is a lookup
and counts nothing.  Causal attention: ``counts.attention_flops`` a layer.
Recomputation under remat is not counted.
"""
from __future__ import annotations

from perfbench.counts import attention_flops


def attention_flops_per_token(m: dict, L: int) -> float:
    return m["n_layers"] * attention_flops(m["n_heads"], m["head_dim"], L)


def flops_per_token(m: dict, L: int) -> float:
    d, H, KV, D, ff = (m["d_model"], m["n_heads"], m["n_kv_heads"],
                       m["head_dim"], m["d_ff"])
    layer = d * H * D + 2 * d * KV * D + H * D * d + 3 * d * ff
    weights = m["n_layers"] * layer + d * m["vocab_size"]
    return 6 * weights + attention_flops_per_token(m, L)
