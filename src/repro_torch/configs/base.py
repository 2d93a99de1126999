"""Architecture configuration system (port of ``repro/configs/base.py``).

One :class:`ModelConfig` describes a member of the model zoo; the port's
carries the fields its families use, and the remat fields of training
(MoE, SSM, hybrid and enc-dec fields arrive with their slices).  The port
registers the architectures whose family it has ported (the dense decoder:
``qwen3-1.7b`` and ``starcoder2-7b``), each as its published config plus a
``reduced()`` variant for CPU tests.  Asking for an architecture of the
reference's zoo that waits for a later slice raises
``NotImplementedError`` naming that slice.
"""
from __future__ import annotations

import dataclasses

import torch

INPUT_SHAPES = {
    # name: (seq_len, global_batch, kind)
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}

#: architectures of the reference zoo that the port has not reached yet,
#: with the slice each waits for
PENDING_ARCHS = {
    "grok-1-314b": "the MoE slice",
    "qwen3-moe-235b-a22b": "the MoE slice",
    "qwen2.5-14b": "the zoo's second dense slice (QKV bias)",
    "minitron-4b": "the zoo's second dense slice",
    "phi-3-vision-4.2b": "the VLM slice",
    "mamba2-130m": "the SSM/Mamba2 slice",
    "zamba2-2.7b": "the hybrid slice",
    "seamless-m4t-medium": "the encoder-decoder slice",
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    source: str                      # citation
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # --- attention options -------------------------------------------------
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    sliding_window: int = 0          # 0 = full attention (training/prefill)
    long_context_window: int = 8192  # SW used for the long_500k decode mode
    mlp_type: str = "swiglu"         # swiglu | gelu
    tie_embeddings: bool = False
    # --- numerics ------------------------------------------------------------
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"   # full | dots (save matmul outputs)

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def param_count(self) -> int:
        """Analytic parameter count of a dense decoder (unpadded vocab)."""
        if self.family != "dense":
            raise NotImplementedError(
                f"param_count of family {self.family!r} arrives with its slice")
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd, H, KV = self.hd, self.n_heads, self.n_kv_heads
        attn = d * (H * hd) + 2 * d * (KV * hd) + (H * hd) * d
        mlp = (3 if self.mlp_type == "swiglu" else 2) * d * ff
        total = self.n_layers * (attn + mlp) + V * d
        if not self.tie_embeddings:
            total += V * d
        return total


_REGISTRY: dict[str, "ArchEntry"] = {}


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    full: ModelConfig
    reduced: ModelConfig


def register(full: ModelConfig, reduced: ModelConfig) -> ArchEntry:
    entry = ArchEntry(full=full, reduced=reduced)
    _REGISTRY[full.name] = entry
    return entry


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    _ensure_loaded()
    if name in PENDING_ARCHS:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet: it waits for "
            f"{PENDING_ARCHS[name]} (ROADMAP Queue 1 item 10)")
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    e = _REGISTRY[name]
    return e.reduced if reduced else e.full


def list_archs() -> list[str]:
    """The ported architectures."""
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    # import every ported arch module for its register() side effect
    from repro_torch.configs import qwen3_1_7b, starcoder2_7b  # noqa: F401
