"""starcoder2-7b [dense] — GQA kv=4, RoPE, native 4k sliding-window attention
[arXiv:2402.19173].
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    source="arXiv:2402.19173",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    mlp_type="gelu",
    sliding_window=4096,     # the model's native SW attention
    rope_theta=1e5,
    long_context_window=4096,
)

REDUCED = ModelConfig(
    name="starcoder2-7b-reduced",
    family="dense",
    source=FULL.source,
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    mlp_type="gelu",
    sliding_window=64,
    dtype="float32",
    remat=False,
)

register(FULL, REDUCED)
