"""minitron-4b [dense] — pruned Nemotron, GQA kv=8, large 256k vocabulary
[arXiv:2407.14679]."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="minitron-4b",
    family="dense",
    source="arXiv:2407.14679",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    mlp_type="gelu",        # nemotron uses squared-relu; gelu is our analogue
    rope_theta=1e4,
    long_context_window=8192,
)

REDUCED = ModelConfig(
    name="minitron-4b-reduced",
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
    dtype="float32",
    remat=False,
)

register(FULL, REDUCED)
