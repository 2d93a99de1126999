"""Architecture configuration system (port of ``repro/configs/base.py``).

One :class:`ModelConfig` describes any member of the model zoo (dense /
moe / ssm / hybrid / encdec / vlm), with the reference's fields but its
layer-scan knobs (``scan_unroll``, ``max_decode_cache``: the port runs its
layers in a Python loop).  Each architecture file registers the published
config plus a ``reduced()`` variant for CPU tests, ``source`` included.
``param_count`` / ``active_param_count`` copy the reference's formulas for
every family.  Asking :func:`get_config` for an architecture whose family
waits for a later slice (the enc-dec ``seamless-m4t-medium``) raises
``NotImplementedError`` naming that slice; its config is still registered.
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
    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- SSM (mamba2 / SSD) --------------------------------------------------
    ssm_state: int = 0               # N
    ssm_head_dim: int = 64           # P
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # --- hybrid (zamba2) -----------------------------------------------------
    shared_attn_every: int = 0       # insert the shared attn block every k layers
    # --- encoder-decoder -----------------------------------------------------
    n_encoder_layers: int = 0
    # --- vlm -----------------------------------------------------------------
    n_vision_tokens: int = 0         # patch embeddings prepended (stub frontend)
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

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (total; experts counted fully; the
        unpadded vocabulary).  The reference's formulas as they stand: the
        hybrid family counts ``n_layers`` Mamba2 layers, though its model
        holds ``n_layers // shared_attn_every`` groups of
        ``shared_attn_every - 1``."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd, H, KV = self.hd, self.n_heads, self.n_kv_heads
        attn = d * (H * hd) + 2 * d * (KV * hd) + (H * hd) * d
        mlp = (3 if self.mlp_type == "swiglu" else 2) * d * ff
        if self.family in ("dense", "vlm"):
            total = self.n_layers * (attn + mlp)
        elif self.family == "moe":
            total = self.n_layers * (attn + self.n_experts * 3 * d * ff
                                     + d * self.n_experts)
        elif self.family == "ssm":
            total = self.n_layers * self._ssm_layer_params()
        elif self.family == "hybrid":
            # the shared block's params counted once
            total = self.n_layers * self._ssm_layer_params() + (attn + mlp)
        elif self.family == "encdec":
            enc = self.n_encoder_layers * (attn + mlp)
            dec = self.n_layers * (2 * attn + mlp)  # self + cross attention
            total = enc + dec
        else:
            raise ValueError(self.family)
        total += V * d  # embedding (+ tied unembed)
        if not self.tie_embeddings:
            total += V * d
        return total

    def _ssm_layer_params(self) -> int:
        d, di, N = self.d_model, self.ssm_inner, self.ssm_state
        H = self.ssm_heads
        in_proj = d * (2 * di + 2 * N + H)   # z, x, B, C, dt
        conv = (di + 2 * N) * self.ssm_conv_width
        out = di * d
        return in_proj + conv + out + 2 * H  # + A_log, D

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        if self.family != "moe":
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        inactive = (self.n_layers * (self.n_experts - self.experts_per_token)
                    * 3 * d * ff)
        return self.param_count() - inactive


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
    """The architectures :func:`get_config` serves (registered, not
    pending)."""
    _ensure_loaded()
    return sorted(set(_REGISTRY) - set(PENDING_ARCHS))


_LOADED = False


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    # import every arch module for its register() side effect
    from repro_torch.configs import (  # noqa: F401
        grok_1_314b,
        mamba2_130m,
        minitron_4b,
        phi_3_vision_4_2b,
        qwen2_5_14b,
        qwen3_1_7b,
        qwen3_moe_235b_a22b,
        seamless_m4t_medium,
        starcoder2_7b,
        zamba2_2_7b,
    )
