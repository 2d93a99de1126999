"""Reduced sizes of the ``mla_moe`` family (DeepSeek-V2-Lite's share) for
the CPU tests, and the program's configuration fields they set: one dense
and two MoE layers, 4 routed experts of which 2 are held, top-2, one
shared expert."""

MODEL = {"d_model": 64, "n_layers": 3, "n_heads": 4, "kv_lora_rank": 32,
         "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
         "d_ff": 96, "moe_d_ff": 32, "first_k_dense": 1,
         "n_routed_experts": 4, "experts_held": 2, "experts_per_token": 2,
         "n_shared_experts": 1, "vocab_size": 500, "vocab_padded": 512}

#: over MODEL on the card: the true head dims 128 + 64 / 128, at which
#: training attends through the flash kernels' (192, 128) instantiation
CARD = {"n_heads": 2, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
        "v_head_dim": 128}


def port_fields(m: dict) -> dict:
    return {"n_layers": m["n_layers"], "d_model": m["d_model"],
            "n_heads": m["n_heads"], "n_kv_heads": m["n_heads"],
            "head_dim": m["qk_nope_head_dim"] + m["qk_rope_head_dim"],
            "d_ff": m["d_ff"], "vocab_size": m["vocab_size"],
            "n_experts": m["n_routed_experts"],
            "experts_held": m["experts_held"],
            "experts_per_token": m["experts_per_token"],
            "kv_lora_rank": m["kv_lora_rank"],
            "qk_nope_head_dim": m["qk_nope_head_dim"],
            "qk_rope_head_dim": m["qk_rope_head_dim"],
            "v_head_dim": m["v_head_dim"],
            "n_shared_experts": m["n_shared_experts"],
            "moe_d_ff": m["moe_d_ff"], "first_k_dense": m["first_k_dense"]}
