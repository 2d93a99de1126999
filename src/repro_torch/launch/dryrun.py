"""Dry run on ``meta``: what every (architecture x input-shape) needs on a
mesh, without allocating it (port of ``repro/launch/dryrun.py``).

The reference lowers and compiles each combination on 512 placeholder
host devices and reads XLA's analyses.  The port builds the model and the
DEPOSITUM state on the ``meta`` device (shapes and dtypes, no storage) and
reckons, under the reference's :class:`~repro_torch.launch.sharding.
Placement` on a mesh of the given shape:

* parameters, bytes of one tree a client, the number of trees (5; 9 with
  compressed gossip's error-feedback memory);
* per-device state bytes under the placement's specs;
* ``model_flops`` and the three-term ``roofline_terms`` over
  :data:`~repro_torch.launch.mesh.HW`;
* the gossip's collective bytes a device a comm round
  (:func:`~repro_torch.analysis.comm.device_wire_bytes` for the plan the
  mixer picks);
* how many clients' state fits in the card's memory: the state's trees
  plus the round program's step temporaries (:data:`STEP_TEMP_TREES`
  trees a client at its peak, with donated rounds).

XLA's ``memory_analysis`` / ``cost_analysis``, the scan-depth calibration
and the HLO collective parse have no ``meta`` counterpart: they are
emitted as ``"not_applicable"`` with the reason, never as numbers.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape train_4k [--mesh 1x1] [--multi-pod] [--out experiments/dryrun]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

import torch

from repro_torch.analysis.comm import device_wire_bytes
from repro_torch.analysis.roofline import model_flops, roofline_terms
from repro_torch.configs.base import INPUT_SHAPES, get_config, list_archs
from repro_torch.core.depositum import DepositumState
from repro_torch.core.mixing import MixPlan
from repro_torch.launch.gossip_dist import plan_for_topology
from repro_torch.launch.mesh import Mesh, PRODUCTION_SHAPES, parse_mesh
from repro_torch.launch.sharding import (
    _axis_size,
    make_placement,
    shard_shape,
    spec_for,
    with_client_dim,
)
from repro_torch.launch.specs import (
    decode_cache_specs,
    decode_token_specs,
    prefill_specs,
    train_batch_specs,
)
from repro_torch.models import build_model

#: the card's memory, NVIDIA's H100 SXM datasheet figure (80 GB)
CARD_BYTES = 80e9
#: client trees live at a donated step's peak beyond the state's own: the
#: fresh gradient tree and the tracking step's new y, both written while
#: the trees they replace are still read
STEP_TEMP_TREES = 2
#: the round program's own passes over one tree a step: the two sweep
#: kernels (update: x, y, nu in, x, nu out; tracking: y, g, g_old in, y
#: out) and the forward / backward reads of x
STEP_TREE_PASSES = 5 + 4 + 2

_NA = {
    "memory_analysis": "XLA's buffer assignment of a compiled program; the "
                       "port compiles none (the state bytes below are "
                       "reckoned from the meta tensors)",
    "cost_analysis": "XLA's HLO cost model of a compiled program; the port "
                     "compiles none (model_flops stands in)",
    "cost_corrected": "the scan-depth calibration corrects XLA's cost "
                      "analysis, which the port has not",
    "collectives": "parsed from compiled HLO in the reference; the port "
                   "counts its collectives as it runs them "
                   "(repro_torch.analysis.hlo)",
}


def _flatten(tree, prefix: str = "") -> dict:
    """A nested axes tree (dicts, per-layer lists) -> dotted names, the
    names ``named_parameters`` gives its module's leaves."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tuple(tree)}


def shapes_and_axes(model):
    """(``meta`` parameters, axes): flat dicts by ``named_parameters``
    name, from the model's ``init`` on ``meta``."""
    module, axes = model.init(0)
    flat_axes = _flatten(axes)
    shapes = {k: p for k, p in module.named_parameters()}
    return shapes, {k: flat_axes[k] for k in shapes}


def state_specs(model, n_clients: int, compressed: bool = False):
    """(``meta`` state, axes) for the full DEPOSITUM state: five trees of
    ``(n_clients, ...)`` leaves, nine with compressed gossip's memory."""
    from repro_torch.core.compression import CommMemory

    p_shapes, p_axes = shapes_and_axes(model)

    def tree():
        return {k: torch.empty((n_clients,) + tuple(s.shape), dtype=s.dtype,
                               device="meta") for k, s in p_shapes.items()}

    ax = with_client_dim(p_axes)
    comm = ()
    comm_axes = ()
    if compressed:
        comm = {v: CommMemory(xhat=tree(), s=tree()) for v in ("x", "y")}
        comm_axes = {v: CommMemory(xhat=ax, s=ax) for v in ("x", "y")}
    shapes = DepositumState(x=tree(), y=tree(), nu=tree(), mu=tree(),
                            g=tree(), t=0, comm=comm)
    axes = DepositumState(x=ax, y=ax, nu=ax, mu=ax, g=ax, t=(),
                          comm=comm_axes)
    return shapes, axes


def _trees(state) -> list:
    out = [state.x, state.y, state.nu, state.mu, state.g]
    for mem in (state.comm or {}).values():
        out += [mem.xhat, mem.s]
    return out


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _device_bytes(placement, axes: dict, tree: dict) -> int:
    """Per-device bytes of one tree under the placement's specs."""
    return sum(_nbytes(shard_shape(placement, spec_for(
        placement, axes[k], tuple(v.shape)), v.shape), v.dtype)
        for k, v in tree.items())


def _tree_device_bytes(placement, axes_tree, tree) -> int:
    """Per-device bytes of any (axes, meta tensors) tree pair."""
    from repro_torch.launch.sharding import _map

    total = []

    def one(a, s):
        if hasattr(s, "shape"):
            total.append(_nbytes(shard_shape(placement, spec_for(
                placement, a, tuple(s.shape)), s.shape), s.dtype))
        return None

    _map(one, axes_tree, tree)
    return sum(total)


def make_mesh(mesh: str | None, multi_pod: bool) -> Mesh:
    """The abstract mesh of ``--mesh`` (default: the reference's production
    shape)."""
    pairs = (parse_mesh(mesh, multi_pod) if mesh
             else PRODUCTION_SHAPES[bool(multi_pod)])
    return Mesh.abstract(pairs)


def run_one(arch: str, shape_name: str, *, mesh: str | None = None,
            multi_pod: bool = False, mixer_kind: str = "dense",
            topology: str = "ring", n_clients: int | None = None,
            compressed: bool = False) -> dict:
    """The dry run's record of one (arch x shape) on a mesh."""
    t0 = time.perf_counter()
    cfg = get_config(arch)
    model = build_model(cfg, device="meta")
    m = make_mesh(mesh, multi_pod)
    chips = m.size
    seq, global_batch, kind = INPUT_SHAPES[shape_name]
    p_shapes, p_axes = shapes_and_axes(model)
    params = sum(p.numel() for p in p_shapes.values())
    tree_bytes = sum(_nbytes(p.shape, p.dtype) for p in p_shapes.values())
    result = {
        "arch": arch, "shape": shape_name, "kind": kind,
        "mesh": m.shape, "chips": chips, "mixer": mixer_kind,
        "topology": topology, "dtype": str(cfg.torch_dtype).split(".")[-1],
        "params": params, "param_bytes": tree_bytes,
        **{k: {"not_applicable": v} for k, v in _NA.items()},
    }
    mf = model_flops(cfg, shape_name)
    if kind == "train":
        placement = make_placement(arch, m, role="train")
        n = n_clients or placement.n_clients
        st_shapes, st_axes = state_specs(model, n, compressed)
        trees = _trees(st_shapes)
        dev_tree = _device_bytes(placement, st_axes.x, st_shapes.x)
        state_dev = dev_tree * len(trees)
        b_shapes, b_axes = train_batch_specs(cfg, shape_name, n)
        # the clients a device holds: all n, or a block of them where the
        # placement shards the client dim (read off the largest leaf)
        big = max(st_shapes.x, key=lambda k: st_shapes.x[k].numel())
        spec = spec_for(placement, st_axes.x[big],
                        tuple(st_shapes.x[big].shape))
        c_axes = spec[0] if spec else None
        c_devices = _axis_size(m, c_axes) if c_axes else 1
        local = n // c_devices
        per_client_dev = dev_tree / local
        d_dev = int(per_client_dev // torch.empty(
            (), dtype=cfg.torch_dtype).element_size())
        plan = (plan_for_topology(topology, n, device="cpu")
                if mixer_kind == "ppermute"
                else MixPlan.from_topology(topology, n, device="cpu"))
        wire = device_wire_bytes(plan, d_dev, n, c_devices)
        rl = roofline_terms(mf / chips, STEP_TREE_PASSES * dev_tree, wire,
                            per_device=True, chips=chips)
        result.update({
            "n_clients": n, "n_trees": len(trees),
            "tree_bytes_per_client": tree_bytes,
            "state_bytes": tree_bytes * n * len(trees),
            "state_bytes_per_device": state_dev,
            "step_temp_trees_per_client": STEP_TEMP_TREES,
            "step_temp_bytes_per_device": per_client_dev * STEP_TEMP_TREES
            * local,
            "batch_bytes": sum(_nbytes(v.shape, v.dtype)
                               for v in b_shapes.values()),
            "card_bytes": CARD_BYTES,
            "clients_fit_per_device": int(
                CARD_BYTES // (per_client_dev * (len(trees)
                                                 + STEP_TEMP_TREES))),
            "collective_bytes_per_device": wire,
            "collective_plan": plan.kind,
        })
    elif kind == "prefill":
        placement = make_placement(arch, m, role="serve")
        b_shapes, b_axes = prefill_specs(cfg, shape_name)
        p_dev = _device_bytes(placement, p_axes, p_shapes)
        rl = roofline_terms(mf / chips, p_dev, 0.0, per_device=True,
                            chips=chips)
        result.update({
            "param_bytes_per_device": p_dev,
            "batch_bytes_per_device": _tree_device_bytes(placement, b_axes,
                                                         b_shapes)})
    else:
        placement = make_placement(arch, m, role="serve")
        c_shapes, c_axes = decode_cache_specs(cfg, shape_name)
        t_shapes, _t_axes = decode_token_specs(cfg, shape_name)
        p_dev = _device_bytes(placement, p_axes, p_shapes)
        c_dev = _tree_device_bytes(placement, c_axes, c_shapes)
        rl = roofline_terms(mf / chips, p_dev + c_dev, 0.0, per_device=True,
                            chips=chips)
        result.update({"param_bytes_per_device": p_dev,
                       "cache_bytes_per_device": c_dev})
    rl["model_flops_global"] = mf
    result["roofline"] = rl
    result["reckon_s"] = time.perf_counter() - t0
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="an architecture, or 'all'")
    ap.add_argument("--shape", default="train_4k", choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default="",
                    help="DxM (or PxDxM); default the reference's "
                         "production shape, 1x1 for one card")
    ap.add_argument("--mixer", default="dense", choices=["dense", "ppermute"])
    ap.add_argument("--topology", default="ring")
    ap.add_argument("--clients", type=int, default=0,
                    help="clients on the state (default: the placement's)")
    ap.add_argument("--compressed", action="store_true",
                    help="count compressed gossip's error-feedback memory")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)
    archs = list_archs() if args.arch == "all" else [args.arch]
    results = []
    for arch in archs:
        res = run_one(arch, args.shape, mesh=args.mesh or None,
                      multi_pod=args.multi_pod, mixer_kind=args.mixer,
                      topology=args.topology,
                      n_clients=args.clients or None,
                      compressed=args.compressed)
        print(json.dumps(res), flush=True)
        results.append(res)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            mesh_tag = "x".join(str(v) for v in res["mesh"].values())
            tag = f"{arch}__{args.shape}__{mesh_tag}__{args.mixer}"
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(res, f, indent=2)
    return results


if __name__ == "__main__":
    main()
