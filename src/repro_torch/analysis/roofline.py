"""Three-term roofline (port of ``repro/analysis/roofline.py``) over the
card's hardware model, :data:`repro_torch.launch.mesh.HW`::

    t_compute    = FLOPs      / peak bf16 FLOP/s
    t_memory     = HBM bytes  / HBM bandwidth
    t_collective = coll bytes / one link's bandwidth

Inputs are per device (``per_device=True``) or global totals over
``chips``.  The same formulas as the reference's, read against an H100's
constants in place of a TPU v5e's.
"""
from __future__ import annotations

from repro_torch.configs.base import INPUT_SHAPES, ModelConfig
from repro_torch.launch.mesh import HW


def roofline_terms(
    flops: float,
    hbm_bytes: float,
    coll_bytes: float,
    *,
    per_device: bool = True,
    chips: int = 256,
) -> dict:
    """All inputs per-device when per_device=True, else global totals."""
    scale = 1.0 if per_device else 1.0 / chips
    t_compute = flops * scale / HW["peak_flops_bf16"]
    t_memory = hbm_bytes * scale / HW["hbm_bandwidth"]
    t_coll = coll_bytes * scale / HW["ici_bandwidth"]
    terms = {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
    }
    dom = max(terms, key=terms.get)
    bound = max(t_compute, t_memory, t_coll)
    terms["dominant"] = dom.replace("t_", "").replace("_s", "")
    terms["step_lower_bound_s"] = bound
    # fraction of the bound spent doing useful math
    terms["compute_fraction"] = t_compute / bound if bound > 0 else 0.0
    return terms


def fused_sweep_traffic(d: int, S: int, C: int, *, dtype_bytes: int = 4,
                        padded: int | None = None) -> dict:
    """HBM-traffic / FLOP model for the sweep-major fused DEPOSITUM update.

    The fused kernel (``prox_sweep.cu``) reads {x, y, nu} and writes {x',
    nu'} once per element: 5 array sweeps over the whole (S, C, d) grid.
    The unfused sequence of tensor ops materialises the momentum and the
    prox argument between them: read {y, nu} write nu' (3 sweeps), read
    {x, nu'} write the shifted point (3), read it back and write x' (2):
    8 sweeps.  FLOPs per element: 3 (momentum axpy) + 2 (prox shift) + ~4
    (soft threshold select chain) = 9; the kernel is memory-bound by two
    orders of magnitude, so the ratio of sweeps is the predicted speedup.

    ``padded`` (elements per client after padding) gives the bytes the
    kernel actually moves; defaults to the logical ``d``.
    """
    n = float(S) * C * (padded if padded is not None else d)
    fused_bytes = 5.0 * n * dtype_bytes
    unfused_bytes = 8.0 * n * dtype_bytes
    flops = 9.0 * n
    return {
        "elements": n,
        "fused_bytes": fused_bytes,
        "unfused_bytes": unfused_bytes,
        "hbm_sweep_ratio": unfused_bytes / fused_bytes,
        "flops": flops,
        "arithmetic_intensity": flops / fused_bytes,
    }


def fused_sweep_roofline(traffic: dict, measured_s: float) -> dict:
    """Achieved-vs-roofline for one measured fused-sweep kernel time
    (meaningful for a time measured on the card; a CPU time only says how
    far the plain version is from the card's model)."""
    bw = HW["hbm_bandwidth"]
    t_mem = traffic["fused_bytes"] / bw
    achieved = traffic["fused_bytes"] / measured_s if measured_s > 0 else 0.0
    return {
        "roofline_t_memory_s": t_mem,
        "achieved_gbps": achieved / 1e9,
        "roofline_fraction": achieved / bw,
    }


def model_flops(cfg: ModelConfig, shape_name: str, n_clients: int = 1) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N_active*D (inference) global."""
    seq, global_batch, kind = INPUT_SHAPES[shape_name]
    n_active = cfg.active_param_count()
    if kind == "train":
        tokens = seq * global_batch
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = seq * global_batch
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * global_batch
