"""qwen2.5-14b [dense] — GQA kv=8 with QKV bias [hf:Qwen/Qwen2.5-0.5B family,
scaled per assignment]."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    source="hf:Qwen/Qwen2.5-0.5B",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    long_context_window=8192,
)

REDUCED = ModelConfig(
    name="qwen2.5-14b-reduced",
    family="dense",
    source=FULL.source,
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    qkv_bias=True,
    dtype="float32",
    remat=False,
)

register(FULL, REDUCED)
