"""qwen3-moe-235b-a22b [moe] — 94 layers, 128 experts top-8, GQA kv=4,
qk-norm [hf:Qwen/Qwen3-30B-A3B family scaled per assignment].
d_ff=1536 is the per-expert intermediate size.
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    qk_norm=True,
    n_experts=128,
    experts_per_token=8,
    rope_theta=1e6,
    long_context_window=8192,
)

REDUCED = ModelConfig(
    name="qwen3-moe-235b-a22b-reduced",
    family="moe",
    source=FULL.source,
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=64,
    vocab_size=512,
    qk_norm=True,
    n_experts=4,
    experts_per_token=2,
    dtype="float32",
    remat=False,
)

register(FULL, REDUCED)
