"""RMSNorm forward and backward: a hand-written CUDA kernel pair."""
