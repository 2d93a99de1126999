"""Feed-forward blocks: SwiGLU / GELU MLP and capacity-based top-k MoE
(port of ``repro/models/mlp.py``)."""
from __future__ import annotations

import torch
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


# ---------------------------------------------------------------------------
# Mixture of Experts: GShard/Switch-style static-capacity dispatch, as the
# reference computes it (plain tensor ops: the reference has no kernel).
# ---------------------------------------------------------------------------

def init_moe(ini: Initializer, cfg: ModelConfig):
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ini.normal((d, E), ("embed", None), scale=0.02),
        "w_gate": ini.normal((E, d, ff), ("experts", "embed", "mlp")),
        "w_up": ini.normal((E, d, ff), ("experts", "embed", "mlp")),
        "w_down": ini.normal((E, ff, d), ("experts", "mlp", "embed")),
    }


def top_k(probs, k: int):
    """(values, indices) of the ``k`` largest entries of the last axis,
    ties to the lower index as ``jax.lax.top_k`` breaks them: a stable
    descending sort (``torch.topk`` does not document its tie order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe(params, x, cfg: ModelConfig):
    """x: (B, L, d) -> (out, aux_loss).  Top-k routing with capacity drop.

    Dispatch rows are (token, k) pairs (R = T*K rows) in that order; each
    row goes to one expert buffer slot, its expert's running count.  Rows
    beyond an expert's capacity C are dropped.  The reference adds every
    row (dropped ones as zeros) into the buffer; here the kept rows are
    copied into their slots, which are distinct, and the dropped rows into
    one spare slot past the buffer that nothing reads: the same buffer,
    exactly, with no host sync.
    """
    B, L, d = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    T = B * L
    xt = x.reshape(T, d)

    logits = (xt @ params["router"]).to(torch.float32)        # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, K)                      # (T, K)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    # load-balance auxiliary loss (Switch): E * sum_e f_e * p_e
    me = torch.mean(probs, dim=0)                              # mean router prob
    one_hot_topk = F.one_hot(gate_idx, E).to(torch.float32)    # (T, K, E)
    fe = torch.mean(torch.sum(one_hot_topk, dim=1), dim=0)     # routed fraction
    aux = E * torch.sum(me * fe / K)

    C = max(1, int(cfg.capacity_factor * T * K / E))  # static, on the host

    flat_idx = gate_idx.reshape(-1)                            # (R,) expert ids
    row_onehot = F.one_hot(flat_idx, E)                        # (R, E)
    pos = torch.sum(torch.cumsum(row_onehot, dim=0) * row_onehot, dim=-1) - 1
    keep = pos < C
    pos = torch.clamp(pos, 0, C - 1)

    x_rows = xt.repeat_interleave(K, dim=0)                    # (R, d)
    buf_idx = flat_idx * C + pos                               # (R,) slot ids
    spare = torch.full_like(buf_idx, E * C)
    expert_in = xt.new_zeros((E * C + 1, d)).index_copy(
        0, torch.where(keep, buf_idx, spare), x_rows)[:E * C].reshape(E, C, d)

    # batched expert FFN (swiglu)
    h = F.silu(torch.bmm(expert_in, params["w_gate"]))
    h = h * torch.bmm(expert_in, params["w_up"])
    expert_out = torch.bmm(h, params["w_down"])

    # combine: gather each row's slot, weight by its (renormalised) gate
    gates_row = (gate_vals.reshape(-1).to(xt.dtype)
                 * keep.to(xt.dtype))
    out_rows = expert_out.reshape(E * C, d)[buf_idx] * gates_row[:, None]
    out = out_rows.reshape(T, K, d).sum(dim=1)
    return out.reshape(B, L, d), aux
