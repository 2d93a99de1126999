"""seamless-m4t-medium [audio] — enc-dec multimodal translator
[arXiv:2308.11596].  12 speech-encoder layers + 12 text-decoder layers at
d_model=1024.  The mel-spectrogram + conv feature extractor is the sanctioned
stub: ``input_specs`` provides precomputed frame embeddings (B, S, d_model).
Simplification vs the published conformer encoder: plain transformer encoder
blocks (no macaron conv module) — noted in DESIGN.md.
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    source="arXiv:2308.11596",
    n_layers=12,             # text decoder
    n_encoder_layers=12,     # speech encoder
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    mlp_type="gelu",
    long_context_window=8192,
)

REDUCED = ModelConfig(
    name="seamless-m4t-medium-reduced",
    family="encdec",
    source=FULL.source,
    n_layers=2,
    n_encoder_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    d_ff=512,
    vocab_size=512,
    mlp_type="gelu",
    dtype="float32",
    remat=False,
)

register(FULL, REDUCED)
