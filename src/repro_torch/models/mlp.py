"""Feed-forward blocks: SwiGLU / GELU MLP (port of ``repro/models/mlp.py``).

The capacity-based top-k MoE arrives with the expert slice.
"""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Initializer


def init_mlp(ini: Initializer, cfg: ModelConfig, d_ff: int | None = None):
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp_type == "swiglu":
        return {
            "w_gate": ini.normal((d, ff), ("embed", "mlp")),
            "w_up": ini.normal((d, ff), ("embed", "mlp")),
            "w_down": ini.normal((ff, d), ("mlp", "embed")),
        }
    return {
        "w_up": ini.normal((d, ff), ("embed", "mlp")),
        "w_down": ini.normal((ff, d), ("mlp", "embed")),
    }


def mlp(params, x, cfg: ModelConfig):
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ params["w_up"], approximate="tanh")
    return h @ params["w_down"]


def init_moe(ini: Initializer, cfg: ModelConfig):
    raise NotImplementedError("MoE arrives with the expert slice "
                              "(ROADMAP Queue 1 item 10)")


def moe(params, x, cfg: ModelConfig):
    raise NotImplementedError("MoE arrives with the expert slice "
                              "(ROADMAP Queue 1 item 10)")
