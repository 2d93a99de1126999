"""Feed-forward blocks: SwiGLU / GELU MLP and capacity-based top-k MoE
(port of ``repro/models/mlp.py``), and the ``mla_moe`` family's
DeepSeekMoE layer (:func:`expert_share`), which the reference has no
counterpart of.

:func:`expert_share` is one chip's share of an expert-parallel DeepSeekMoE
layer: the router keeps its published width (all ``n_experts`` outputs,
in fp32), each token goes to its top ``experts_per_token`` by softmax
probability (weights as they are unless ``norm_topk_prob``, times
``routed_scaling_factor``), and the layer computes the part of the output
that the experts it holds (``experts_held`` from ``expert_offset``) give,
for every (token, expert) row routed to them: no row is dropped.  The
shared experts (one SwiGLU of ``n_shared_experts x moe_d_ff``) run on
every token.  The rows are sorted by held expert on the device and the
three products (gate, up, down) are one grouped launch each over the held
experts (:func:`grouped_mm`: ``torch._grouped_mm``, CUTLASS's sm90 grouped
GEMM, on bf16 CUDA tensors; a loop over the groups elsewhere), with each
expert's rows given by offsets on the device: the dispatch makes no
device-to-host synchronisation.  The balance loss is DeepSeek's
``seq_aux`` over all the router's outputs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Initializer, cast
from repro_torch.obs import trace


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


# ---------------------------------------------------------------------------
# DeepSeekMoE: one chip's share of an expert-parallel layer, dropless
# ---------------------------------------------------------------------------

def init_expert_share(ini: Initializer, cfg: ModelConfig):
    """The router, the held experts stacked (``w_gate`` (held, d, ff), ...)
    at 1 / sqrt(fan-in) of each product, and the shared experts."""
    d, ff, n = cfg.d_model, cfg.moe_d_ff, cfg.held
    return {
        "router": ini.normal((d, cfg.n_experts), ("embed", None)),
        "w_gate": ini.normal((n, d, ff), ("experts", "embed", "mlp"),
                             scale=d ** -0.5),
        "w_up": ini.normal((n, d, ff), ("experts", "embed", "mlp"),
                           scale=d ** -0.5),
        "w_down": ini.normal((n, ff, d), ("experts", "mlp", "embed"),
                             scale=ff ** -0.5),
        "shared": init_mlp(ini, cfg, d_ff=cfg.n_shared_experts * ff),
    }


def grouped_mm_plain(x, w, offs):
    """Plain version of :func:`grouped_mm`: ``out[s:e] = x[s:e] @ w[g]``
    for group g's rows ``[offs[g - 1], offs[g])``; rows past the last
    group are 0."""
    out = x.new_zeros((x.shape[0], w.shape[2]))
    start = 0
    for g, end in enumerate(offs.tolist()):
        if end > start:
            out[start:end] = x[start:end] @ w[g]
        start = end
    return out


def grouped_mm(x, w, offs):
    """x (R, k) rows sorted by group, w (G, k, n), offs (G,) int32 group
    ends on x's device -> (R, n), group g's rows times ``w[g]``.  bf16 CUDA
    tensors run ``torch._grouped_mm`` (one launch, no synchronisation; its
    rows past the last group are not written, so callers mask them);
    anything else :func:`grouped_mm_plain`."""
    if x.device.type == "cuda" and x.dtype == torch.bfloat16:
        return torch._grouped_mm(x, w, offs=offs)
    return grouped_mm_plain(x, w, offs)


def route(xt, router, cfg: ModelConfig):
    """(probs (T, E) fp32, top-k ids (T, K), their weights (T, K) fp32):
    the router over all its outputs in fp32, greedy top-k."""
    logits = cast(xt, torch.float32) @ cast(router, torch.float32)
    probs = torch.softmax(logits, dim=-1)
    weights, ids = top_k(probs, cfg.experts_per_token)
    if cfg.norm_topk_prob:
        weights = weights / torch.sum(weights, dim=-1, keepdim=True)
    return probs, ids, weights * cfg.routed_scaling_factor


def seq_aux_loss(probs, ids, B: int, L: int):
    """DeepSeek's sequence-wise balance loss (``seq_aux``), without its
    alpha: per sequence, each expert's count of top-k rows times E / (L K),
    times its mean router probability over the sequence, summed over
    experts; the mean over sequences."""
    E, K = probs.shape[-1], ids.shape[-1]
    counts = probs.new_zeros((B, E)).scatter_add_(
        1, ids.reshape(B, L * K), probs.new_ones((B, L * K)))
    share = counts / (L * K / E)
    return torch.mean(torch.sum(share * probs.reshape(B, L, E).mean(1), 1))


def dispatch(xt, ids, cfg: ModelConfig):
    """The held experts' rows, sorted by expert, with no host sync:
    ``x_rows`` (R, d) the (token, k) rows' inputs, those routed to held
    experts first and grouped by expert (stable), zeros for the rest;
    ``order`` (R,) the sorted rows' (token, k) indices; ``offs`` (held,)
    int32 group ends; ``valid`` (R,) whether a sorted row is a held
    expert's."""
    n, K = cfg.held, ids.shape[-1]
    local = ids.reshape(-1) - cfg.expert_offset
    key = torch.where((local >= 0) & (local < n), local,
                      torch.full_like(local, n))
    order = torch.sort(key, stable=True).indices
    counts = torch.zeros(n + 1, dtype=torch.int64, device=ids.device
                         ).index_add_(0, key, torch.ones_like(key))
    offs = torch.cumsum(counts[:n], 0).to(torch.int32)
    valid = torch.arange(order.numel(), device=ids.device) < offs[-1]
    x_rows = torch.where(valid[:, None], xt[order // K], 0)
    return x_rows, order, offs, valid


def held_experts(params, x_rows, offs):
    """The held experts' SwiGLU on their sorted rows: three grouped
    products."""
    h = F.silu(grouped_mm(x_rows, params["w_gate"], offs))
    h = h * grouped_mm(x_rows, params["w_up"], offs)
    return grouped_mm(h, params["w_down"], offs)


def _moe(params, x, cfg: ModelConfig):
    B, L, d = x.shape
    T, K = B * L, cfg.experts_per_token
    xt = x.reshape(T, d)
    probs, ids, weights = trace.layer("moe.route", route, xt,
                                      params["router"], cfg)
    aux = seq_aux_loss(probs, ids, B, L)
    x_rows, order, offs, valid = trace.layer("moe.dispatch", dispatch, xt,
                                             ids, cfg)
    y = trace.layer("moe.experts", held_experts, params, x_rows, offs)

    def combine(y, weights):
        # y's rows past the held experts' are not written by the grouped
        # product: masked before the gate multiplies them, so that neither
        # the output nor the gate's gradient reads them
        gate = weights.reshape(-1)[order].to(y.dtype)
        rows = torch.where(valid[:, None], y, 0) * gate[:, None]
        back = torch.empty_like(rows).index_copy_(0, order, rows)
        return back.reshape(T, K, d).sum(dim=1)

    out = trace.layer("moe.combine", combine, y, weights)
    return out.reshape(B, L, d), aux


def expert_share(params, x, cfg: ModelConfig):
    """x: (B, L, d) -> (routed part of the held experts + the shared
    experts' output, the layer's balance loss without alpha).  See the
    module docstring."""
    out, aux = trace.layer("moe", _moe, params, x, cfg)
    shared = trace.layer("shared_expert", mlp, params["shared"], x, cfg)
    return out + shared, aux
