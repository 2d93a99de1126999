"""phi-3-vision-4.2b [vlm] — phi3-mini LM backbone + CLIP vision frontend.

[hf:microsoft/Phi-3-vision-128k-instruct]  The ViT/projector frontend is the
sanctioned stub: ``input_specs`` provides precomputed patch embeddings
(B, n_vision_tokens, d_model).
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    source="hf:microsoft/Phi-3-vision-128k-instruct",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    mlp_type="swiglu",
    rope_theta=1e6,          # long-context rope base (128k variant)
    n_vision_tokens=1024,    # stub CLIP patch embeddings
    long_context_window=8192,
)

REDUCED = ModelConfig(
    name="phi-3-vision-4.2b-reduced",
    family="vlm",
    source=FULL.source,
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    d_ff=512,
    vocab_size=512,
    mlp_type="swiglu",
    n_vision_tokens=8,
    dtype="float32",
    remat=False,
)

register(FULL, REDUCED)
