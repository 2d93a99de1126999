"""Flash-attention forward (port of ``repro/kernels/flash_attention``)."""
