"""deepseek-v2-lite [mla_moe] — 27 layers (1 dense + 26 DeepSeekMoE), d 2048,
multi-head latent attention (no q LoRA, kv_lora_rank 512, q/k heads of
128 + 64 RoPE, v heads of 128), 64 routed experts of 1,408 top-6 (softmax,
not renormalised) with 2 shared, YaRN RoPE (factor 40 over 4,096
positions) [hf:deepseek-ai/DeepSeek-V2-Lite].  A port-only architecture:
the reference's zoo has no latent attention.

Departure, with random weights a relabelling and not a change of model:
DeepSeek-V2 reorders ``q_pe`` / ``k_pe`` from interleaved pairs to halves
before ``rotate_half``; the port's half-split RoPE is that model with the
64 RoPE columns of ``wq`` and ``wkv_a`` permuted.  RMS norm scales are
stored zero-centred (the norm multiplies by ``1 + w``), as in every port
family.
"""
from repro_torch.configs.base import MlaMoeConfig, Yarn, register

YARN = Yarn(factor=40.0, original_max_position_embeddings=4096,
            beta_fast=32.0, beta_slow=1.0, mscale=0.707, mscale_all_dim=0.707)

FULL = MlaMoeConfig(
    name="deepseek-v2-lite",
    family="mla_moe",
    source="hf:deepseek-ai/DeepSeek-V2-Lite",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=192,
    d_ff=10944,
    vocab_size=102400,
    rope_theta=1e4,
    n_experts=64,
    experts_per_token=6,
    router_aux_weight=0.001,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    yarn=YARN,
    n_shared_experts=2,
    moe_d_ff=1408,
    first_k_dense=1,
    norm_topk_prob=False,
    routed_scaling_factor=1.0,
)

REDUCED = MlaMoeConfig(
    name="deepseek-v2-lite-reduced",
    family="mla_moe",
    source=FULL.source,
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=24,
    d_ff=96,
    vocab_size=512,
    rope_theta=1e4,
    n_experts=4,
    experts_per_token=2,
    router_aux_weight=0.001,
    kv_lora_rank=32,
    qk_nope_head_dim=16,
    qk_rope_head_dim=8,
    v_head_dim=16,
    yarn=Yarn(factor=4.0, original_max_position_embeddings=16,
              beta_fast=32.0, beta_slow=1.0, mscale=0.707,
              mscale_all_dim=0.707),
    n_shared_experts=1,
    moe_d_ff=32,
    first_k_dense=1,
    experts_held=2,
    dtype="float32",
    remat=False,
)

register(FULL, REDUCED, port=True)
