"""mamba2-130m [ssm] — SSD (state-space duality) LM [arXiv:2405.21060].
Attention-free: 24 layers, d_model=768, d_inner=1536 (expand 2), 24 SSD heads
of dim 64, state N=128, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    source="arXiv:2405.21060",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=256,
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="mamba2-130m-reduced",
    family="ssm",
    source=FULL.source,
    n_layers=2,
    d_model=128,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=512,
    ssm_state=16,
    ssm_head_dim=32,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=32,
    tie_embeddings=True,
    dtype="float32",
    remat=False,
)

register(FULL, REDUCED)
