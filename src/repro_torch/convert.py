"""Carry parameters and DEPOSITUM state between the reference and the port.

The reference keeps parameters as a nested dict pytree (``{"l0": {"w": ..,
"b": ..}, ..}``); the port as a flat dict with dotted names
(``{"l0.w": .., "l0.b": ..}``), in the reference's leaf order (keys sorted
at every level).  Both sides meet as numpy arrays, so this module imports
neither JAX nor the reference package.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.depositum import DepositumState


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
    leaves are numpy arrays -> the port's state on ``device``."""
    if _field(state, "comm", ()):
        raise NotImplementedError(
            "states with compression memory arrive with the compression "
            "slice (ROADMAP Queue 1)")
    trees = {f: params_from_numpy(_field(state, f), device=device)
             for f in ("x", "y", "nu", "mu", "g")}
    return DepositumState(**trees, t=int(np.asarray(_field(state, "t"))),
                          comm=())


def state_to_numpy(state: DepositumState) -> dict:
    """The port's state -> dict of nested numpy trees (``t`` as int32)."""
    out = {f: params_to_numpy(getattr(state, f))
           for f in ("x", "y", "nu", "mu", "g")}
    out["t"] = np.asarray(state.t, np.int32)
    out["comm"] = ()
    return out
