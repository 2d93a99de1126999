"""qwen3-1.7b [dense] — qk_norm, GQA kv=8 [hf:Qwen/Qwen3-8B family, scaled
per assignment]."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    source="hf:Qwen/Qwen3-8B",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    long_context_window=8192,
)

REDUCED = ModelConfig(
    name="qwen3-1.7b-reduced",
    family="dense",
    source=FULL.source,
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    qk_norm=True,
    dtype="float32",
    remat=False,
)

register(FULL, REDUCED)
