"""grok-1-314b [moe] — 8 experts top-2, GQA kv=8 [hf:xai-org/grok-1].
d_ff=32768 is the per-expert intermediate size."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="grok-1-314b",
    family="moe",
    source="hf:xai-org/grok-1",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    n_experts=8,
    experts_per_token=2,
    mlp_type="swiglu",
    rope_theta=1e4,
    long_context_window=8192,
)

REDUCED = ModelConfig(
    name="grok-1-314b-reduced",
    family="moe",
    source=FULL.source,
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=128,
    vocab_size=512,
    n_experts=4,
    experts_per_token=2,
    mlp_type="swiglu",
    dtype="float32",
    remat=False,
)

register(FULL, REDUCED)
