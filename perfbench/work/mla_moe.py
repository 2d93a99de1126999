"""Training FLOPs of the ``mla_moe`` family (DeepSeek-V2-Lite's share), a
token.

Every matrix product counts 6 FLOPs a weight a token (2 forward, 4
backward), as the dense family's: multi-head latent attention's
``wq``, ``wkv_a``, ``wkv_b`` and ``wo``; the dense layers' SwiGLU; in each
MoE layer the router (all its experts), the shared experts, and the held
experts at the share of a token they expect: ``experts_per_token x
experts_held / n_routed_experts`` experts (6 x 8 / 64 = 0.75) of 3 d x
moe_d_ff weights; the untied head over the vocabulary slice.  Causal
attention: ``3 x 2 x 2 x H x (D_qk + D_v) / 2 x (L + 1) / 2`` a layer
(Q K^T over the q / k head, P V over the value head).  Recomputation
under remat is not counted.
"""
from __future__ import annotations


def attention_flops_per_token(m: dict, L: int) -> float:
    d_qk = m["qk_nope_head_dim"] + m["qk_rope_head_dim"]
    per_layer = 3 * 2 * 2 * m["n_heads"] * (d_qk + m["v_head_dim"]) / 2 * (L + 1) / 2
    return m["n_layers"] * per_layer


def _experts_a_token(m: dict) -> float:
    return m["experts_per_token"] * m["experts_held"] / m["n_routed_experts"]


def expert_flops_per_token(m: dict, L: int) -> float:
    """The held experts' products (gate, up, down) a token, all MoE
    layers."""
    n_moe = m["n_layers"] - m["first_k_dense"]
    return n_moe * 6 * _experts_a_token(m) * 3 * m["d_model"] * m["moe_d_ff"]


def flops_per_token(m: dict, L: int) -> float:
    d, H, r = m["d_model"], m["n_heads"], m["kv_lora_rank"]
    dn, dr, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    mla = d * H * (dn + dr) + d * (r + dr) + r * H * (dn + dv) + H * dv * d
    n_moe = m["n_layers"] - m["first_k_dense"]
    moe = d * m["n_routed_experts"] + m["n_shared_experts"] * 3 * d * m["moe_d_ff"]
    weights = (m["n_layers"] * mla + m["first_k_dense"] * 3 * d * m["d_ff"]
               + n_moe * moe + d * m["vocab_size"])
    return (6 * weights + expert_flops_per_token(m, L)
            + attention_flops_per_token(m, L))
