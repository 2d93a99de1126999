"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention block
[arXiv:2411.15242].  54 mamba2 layers (d_model=2560, state N=64) with one
shared attention+MLP block (32 heads, d_ff=10240) invoked every 6 layers.
Simplification vs published: the shared block is reused verbatim (the paper
adds per-invocation LoRA deltas) — noted in DESIGN.md.
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    source="arXiv:2411.15242",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=256,
    shared_attn_every=6,
    long_context_window=8192,
)

REDUCED = ModelConfig(
    name="zamba2-2.7b-reduced",
    family="hybrid",
    source=FULL.source,
    n_layers=4,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    ssm_state=16,
    ssm_head_dim=32,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=32,
    shared_attn_every=2,
    dtype="float32",
    remat=False,
)

register(FULL, REDUCED)
