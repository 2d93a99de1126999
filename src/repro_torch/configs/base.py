"""Architecture configuration system (port of ``repro/configs/base.py``).

One :class:`ModelConfig` describes any member of the model zoo (dense /
moe / ssm / hybrid / encdec / vlm), with the reference's fields but its
layer-scan knobs (``scan_unroll``, ``max_decode_cache``: the port runs its
layers in a Python loop).  Each architecture file registers the published
config plus a ``reduced()`` variant for CPU tests, ``source`` included.
``param_count`` / ``active_param_count`` copy the reference's formulas for
every family.  :func:`get_config` serves all ten architectures of the
reference's zoo, the enc-dec ``seamless-m4t-medium`` included, and the
port's own architectures, which the reference has no counterpart of:
``deepseek-v2-lite`` (:class:`MlaMoeConfig`, family ``mla_moe``), which
:func:`list_archs` leaves out.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

INPUT_SHAPES = {
    # name: (seq_len, global_batch, kind)
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
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


@dataclasses.dataclass(frozen=True)
class Yarn:
    """YaRN RoPE scaling, as DeepSeek-V2's ``rope_scaling`` of type
    "yarn" gives it."""

    factor: float
    original_max_position_embeddings: int
    beta_fast: float
    beta_slow: float
    mscale: float
    mscale_all_dim: float


def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    """DeepSeek-V2's ``yarn_get_mscale``: 0.1 mscale ln(scale) + 1 (1 at
    no scaling)."""
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


@dataclasses.dataclass(frozen=True)
class MlaMoeConfig(ModelConfig):
    """DeepSeek-V2's block (family ``mla_moe``): multi-head latent
    attention (no q LoRA), DeepSeekMoE with shared experts after
    ``first_k_dense`` dense layers, YaRN RoPE on the RoPE part of the
    heads.  A port-only configuration: the reference has no such family.

    ``head_dim`` is the query/key head (``qk_nope_head_dim +
    qk_rope_head_dim``); ``d_ff`` the dense layers' width, ``moe_d_ff`` an
    expert's.  ``n_experts`` is the router's width; the layer holds
    ``experts_held`` of them (0: all), experts ``expert_offset`` onwards, as
    one chip of an expert-parallel deployment does, and computes their
    part of the output alone.  ``router_aux_weight`` is the balance loss's
    alpha, summed over the MoE layers (DeepSeek's ``seq_aux``)."""

    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    yarn: Optional[Yarn] = None
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0
    norm_topk_prob: bool = False
    routed_scaling_factor: float = 1.0
    experts_held: int = 0
    expert_offset: int = 0

    def __post_init__(self):
        # DeepSeek-V2 scales cos and sin by mscale(factor, mscale) /
        # mscale(factor, mscale_all_dim): 1 where the two are equal, as
        # the port's RoPE takes them
        y = self.yarn
        if y is not None and y.mscale != y.mscale_all_dim:
            raise ValueError(f"{self.name}: YaRN mscale {y.mscale} != "
                             f"mscale_all_dim {y.mscale_all_dim}")

    @property
    def held(self) -> int:
        """Routed experts this layer holds."""
        return self.experts_held or self.n_experts

    @property
    def softmax_scale(self) -> float:
        """``1 / sqrt(q/k head dim)``, times ``mscale(factor,
        mscale_all_dim)^2`` under YaRN (DeepSeek-V2's attention)."""
        s = 1.0 / math.sqrt(self.qk_nope_head_dim + self.qk_rope_head_dim)
        if self.yarn is not None and self.yarn.mscale_all_dim:
            m = yarn_mscale(self.yarn.factor, self.yarn.mscale_all_dim)
            s = s * m * m
        return s

    def is_moe_layer(self, i: int) -> bool:
        return i >= self.first_k_dense

    def _mla_params(self) -> int:
        d, H, r = self.d_model, self.n_heads, self.kv_lora_rank
        dn, dr, dv = (self.qk_nope_head_dim, self.qk_rope_head_dim,
                      self.v_head_dim)
        return (d * H * (dn + dr) + d * (r + dr) + r + r * H * (dn + dv)
                + H * dv * d)

    def _expert_params(self) -> int:
        return 3 * self.d_model * self.moe_d_ff

    def param_count(self) -> int:
        """Stored parameters: the held experts only, the untied head and
        the embedding over the (unpadded) vocabulary."""
        d = self.d_model
        dense = 3 * d * self.d_ff
        moe = (d * self.n_experts + self.held * self._expert_params()
               + self.n_shared_experts * self._expert_params())
        n_moe = self.n_layers - self.first_k_dense
        total = self.n_layers * (self._mla_params() + 2 * d)
        total += self.first_k_dense * dense + n_moe * moe
        return total + 2 * self.vocab_size * d + d

    def active_param_count(self) -> int:
        """Parameters a token touches: its ``experts_per_token`` routed
        experts (all held) in place of the held ones."""
        n_moe = self.n_layers - self.first_k_dense
        return self.param_count() - n_moe * (
            self.held - self.experts_per_token) * self._expert_params()


_REGISTRY: dict[str, "ArchEntry"] = {}
#: the port's own architectures (no counterpart in the reference's zoo)
_PORT_REGISTRY: dict[str, "ArchEntry"] = {}


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    full: ModelConfig
    reduced: ModelConfig


def register(full: ModelConfig, reduced: ModelConfig, *,
             port: bool = False) -> ArchEntry:
    """Register an architecture; ``port`` for one of the port's own."""
    entry = ArchEntry(full=full, reduced=reduced)
    (_PORT_REGISTRY if port else _REGISTRY)[full.name] = entry
    return entry


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    _ensure_loaded()
    e = _REGISTRY.get(name) or _PORT_REGISTRY.get(name)
    if e is None:
        raise KeyError(f"unknown arch {name!r}; have "
                       f"{sorted(_REGISTRY) + sorted(_PORT_REGISTRY)}")
    return e.reduced if reduced else e.full


def list_archs() -> list[str]:
    """The reference zoo's architectures :func:`get_config` serves (the
    port's own are left out: no reference compares them)."""
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    # import every arch module for its register() side effect
    from repro_torch.configs import (  # noqa: F401
        deepseek_v2_lite,
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
