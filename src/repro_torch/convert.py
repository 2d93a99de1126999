"""Carry parameters and DEPOSITUM / fedopt state between the reference and
the port.

The reference keeps parameters as a nested dict pytree (``{"l0": {"w": ..,
"b": ..}, ..}``); the port as a flat dict with dotted names
(``{"l0.w": .., "l0.b": ..}``), in the reference's leaf order (keys sorted
at every level).  A zoo transformer's parameters are the exception: the
reference stacks ``blocks`` over layers on axis 0, the port's
:class:`~repro_torch.models.transformer.Transformer` keeps a list of
per-layer trees (:func:`transformer_params_from_numpy`, and back with
:func:`transformer_params_to_numpy`).  Both sides meet
as numpy arrays, so this module imports neither JAX nor the reference
package.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.compression import CommMemory
from repro_torch.core.depositum import DepositumState
from repro_torch.core.fedopt.baselines import FedState


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = v
    return out


def params_from_numpy(tree: Mapping, *, device="cuda") -> dict:
    """Nested dict of arrays -> flat ``name -> tensor`` dict on ``device``."""
    if not isinstance(tree, Mapping):
        raise TypeError(f"expected a dict of parameters, got "
                        f"{type(tree).__name__}")
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v)).to(dev)
            for k, v in _flatten(tree).items()}


def params_to_numpy(d: Mapping) -> dict:
    """Flat ``name -> tensor`` dict -> nested dict of numpy arrays."""
    out: dict = {}
    for name, v in d.items():
        *path, leaf = name.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.detach().cpu().numpy()
    return out


def _field(state: Any, name: str, default=None):
    if isinstance(state, Mapping):
        return state.get(name, default)
    return getattr(state, name, default)


def state_from_numpy(state: Any, *, device="cuda") -> DepositumState:
    """A reference ``DepositumState`` (or a dict with its fields) whose
    leaves are numpy arrays -> the port's state on ``device``.  Its
    ``comm`` (``()``, or ``{"x": .., "y": ..}`` of ``CommMemory`` or of
    dicts with ``xhat`` / ``s``) comes along."""
    trees = {f: params_from_numpy(_field(state, f), device=device)
             for f in ("x", "y", "nu", "mu", "g")}
    comm = _field(state, "comm", ())
    if comm:
        comm = {v: CommMemory(*(params_from_numpy(_field(comm[v], f),
                                                  device=device)
                                for f in CommMemory._fields))
                for v in ("x", "y")}
    return DepositumState(**trees, t=int(np.asarray(_field(state, "t"))),
                          comm=comm or ())


def state_to_numpy(state: DepositumState) -> dict:
    """The port's state -> dict of nested numpy trees (``t`` as int32;
    ``comm`` as ``{"x": {"xhat": .., "s": ..}, "y": ..}`` or ``()``)."""
    out = {f: params_to_numpy(getattr(state, f))
           for f in ("x", "y", "nu", "mu", "g")}
    out["t"] = np.asarray(state.t, np.int32)
    out["comm"] = {v: {f: params_to_numpy(getattr(mem, f))
                       for f in CommMemory._fields}
                   for v, mem in state.comm.items()} if state.comm else ()
    return out


def fed_state_from_numpy(state: Any, *, device="cuda") -> FedState:
    """A reference fedopt ``FedState`` (or a dict with its fields) whose
    leaves are numpy arrays -> the port's :class:`~repro_torch.core.fedopt.
    FedState` on ``device``."""
    trees = {f: params_from_numpy(_field(state, f), device=device)
             for f in ("x", "aux1", "aux2")}
    return FedState(**trees, t=int(np.asarray(_field(state, "t"))))


def fed_state_to_numpy(state: FedState) -> dict:
    """The port's ``FedState`` -> dict of nested numpy trees (``t`` as
    int32, as the reference keeps it)."""
    out = {f: params_to_numpy(getattr(state, f)) for f in ("x", "aux1", "aux2")}
    out["t"] = np.asarray(state.t, np.int32)
    return out


def transformer_params_from_numpy(tree: Mapping, cfg, *, device="cuda") -> dict:
    """The reference's transformer params (nested dict of numpy arrays,
    ``blocks`` stacked over layers on axis 0) -> the port's params tree
    (``blocks`` a list of per-layer dicts) of ``cfg.torch_dtype`` tensors
    on ``device``, ready for ``Transformer(cfg, params)``.

    Every leaf is checked against the shapes the port builds for ``cfg``;
    a missing leaf, a leaf left over, or a shape that differs raises.
    """
    from repro_torch.models.transformer import init_params

    dev = resolve_device(device)
    want, _ = init_params(cfg, device="meta")
    if not isinstance(tree, Mapping) or "blocks" not in tree:
        raise ValueError("expected the reference's params dict with a "
                         "'blocks' entry")

    def leaf(path, v, shape):
        a = np.asarray(v)
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"{path}: shape {a.shape} != {tuple(shape)} "
                             f"for {cfg.name}")
        t = torch.from_numpy(np.ascontiguousarray(a.astype(np.float32)))
        return t.to(device=dev, dtype=cfg.torch_dtype)

    def walk(path, src, ref, layer=None):
        if not isinstance(src, Mapping):
            raise ValueError(f"{path}: expected a dict, got "
                             f"{type(src).__name__}")
        extra = sorted(set(src) - set(ref))
        missing = sorted(set(ref) - set(src))
        if extra or missing:
            raise ValueError(f"{path}: leaves left over {extra}, missing "
                             f"{missing}")
        out = {}
        for k, r in ref.items():
            p = f"{path}/{k}"
            if isinstance(r, Mapping):
                out[k] = walk(p, src[k], r, layer)
            elif layer is None:
                out[k] = leaf(p, src[k], r.shape)
            else:
                a = np.asarray(src[k])
                if a.ndim == 0 or a.shape[0] != cfg.n_layers:
                    raise ValueError(f"{p}: not stacked over "
                                     f"{cfg.n_layers} layers: {a.shape}")
                out[k] = leaf(f"{p}[{layer}]", a[layer], r.shape)
        return out

    top = {k: v for k, v in want.items() if k != "blocks"}
    params = walk("", {k: v for k, v in tree.items() if k != "blocks"}, top)
    params["blocks"] = [walk("/blocks", tree["blocks"], want["blocks"][i], i)
                        for i in range(cfg.n_layers)]
    return params


def _numpy32(t: torch.Tensor) -> np.ndarray:
    """A tensor as a float32 numpy array (bf16 upcast losslessly)."""
    return t.detach().to(device="cpu", dtype=torch.float32).numpy()


def transformer_params_to_numpy(params, cfg) -> dict:
    """The port's transformer params (a :class:`~repro_torch.models.
    transformer.Transformer`, or its params tree with ``blocks`` a list of
    per-layer dicts) -> the reference's layout: a nested dict of float32
    numpy arrays (bf16 upcast losslessly), ``blocks`` stacked over layers
    on axis 0.  The inverse of :func:`transformer_params_from_numpy`."""
    if isinstance(params, torch.nn.Module):
        params = {name: child.tensors()
                  for name, child in params.named_children()
                  if name != "blocks"} | {
            "blocks": [b.tensors() for b in params.blocks]}
    blocks = params["blocks"]
    if len(blocks) != cfg.n_layers:
        raise ValueError(f"{len(blocks)} blocks for {cfg.name}'s "
                         f"{cfg.n_layers} layers")

    def stack(trees):
        first = trees[0]
        if isinstance(first, Mapping):
            return {k: stack([t[k] for t in trees]) for k in first}
        return np.stack([_numpy32(t) for t in trees])

    def walk(tree):
        if isinstance(tree, Mapping):
            return {k: walk(v) for k, v in tree.items()}
        return _numpy32(tree)

    out = {k: walk(v) for k, v in params.items() if k != "blocks"}
    out["blocks"] = stack(blocks)
    return out
