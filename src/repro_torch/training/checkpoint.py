"""Checkpointing: a parameter tree <-> one ``.npz`` file keyed by tree
paths, in the reference's format (port of
``repro/training/checkpoint.py``).

The format: one array per leaf under its ``/``-joined path (dict keys, list
indices; the dotted names of the port's flat dicts split at the dots),
bf16 upcast to float32 on save (npz has no bf16) and cast back on
restore, the step under ``__step__``.  Saves are atomic (write to a
temporary file, then rename).  A restore checks every leaf of the
template: a missing one raises ``KeyError``, a shape that differs
``ValueError``.

A zoo module (:class:`~repro_torch.models.transformer.Transformer`,
:class:`~repro_torch.models.ssm.SSM`, :class:`~repro_torch.models.hybrid.
Hybrid`, :class:`~repro_torch.models.encdec.EncDec`) is saved in the
reference's stacked layout (:func:`~repro_torch.convert.
model_params_to_numpy`: ``blocks/attn/wq`` of shape ``(L, d, H*hd)``, a
hybrid's ``mamba/...`` over ``(n_groups, per_group)``, an enc-dec's
``encoder/...`` and ``decoder/...`` over their layers), so a checkpoint
written by either package restores into the other.  A leaf that is
neither a tensor nor a numeric array raises: nothing is pickled.
"""
from __future__ import annotations

import os
import tempfile
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.convert import (
    _init_fn,
    model_params_from_numpy,
    model_params_to_numpy,
    uniform,
)
from repro_torch.models.encdec import EncDec
from repro_torch.models.hybrid import Hybrid
from repro_torch.models.ssm import SSM
from repro_torch.models.transformer import Transformer

#: the modules of the zoo's families, saved in the reference's layout
ZOO_MODULES = (Transformer, SSM, Hybrid, EncDec)


def _leaves(tree, prefix: str = ""):
    """(path, leaf) pairs of a dict / list tree, dict keys sorted."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            name = "/".join(str(k).split("."))
            yield from _leaves(tree[k], f"{prefix}{name}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _to_numpy(path: str, v) -> np.ndarray:
    """A leaf as the array the file stores; anything but a tensor, a
    number or a numeric array raises ``TypeError``."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            v = v.to(torch.float32)
        return v.numpy()
    if not isinstance(v, (np.ndarray, np.generic, int, float)):
        raise TypeError(f"checkpoint leaf {path!r} is a {type(v).__name__}, "
                        "not a tensor or a numeric array")
    arr = np.asarray(v)
    if arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16":
        # npz cannot store ml_dtypes; upcast losslessly (restore re-casts)
        arr = arr.astype(np.float32)
    if arr.dtype.kind not in "biuf":
        raise TypeError(f"checkpoint leaf {path!r} has dtype {arr.dtype}, "
                        "not a numeric one")
    return arr


def _tree(module_or_tree):
    """What a checkpoint stores of ``module_or_tree``: a zoo module in the
    reference's stacked layout, anything else as it is."""
    if isinstance(module_or_tree, ZOO_MODULES):
        return model_params_to_numpy(module_or_tree)
    return module_or_tree


def save_checkpoint(path: str, tree: Any, step: int | None = None) -> None:
    arrays = {p: _to_numpy(p, v) for p, v in _leaves(_tree(tree))}
    if step is not None:
        arrays["__step__"] = np.asarray(step)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)),
                               suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _checked(data, key: str, shape) -> np.ndarray:
    if key not in data:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    arr = data[key]
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"shape mismatch at {key}: ckpt {arr.shape} vs "
                         f"template {tuple(shape)}")
    return arr


def _stacked_shapes(tree, prefix: str = "", lead: tuple = ()):
    """(path, shape) of every leaf of a port params tree in the reference's
    layout: each list of per-layer trees stacked on a leading axis, or
    kept apart where its layers differ (``convert.uniform``)."""
    if isinstance(tree, list) and not uniform(tree):
        for i, t in enumerate(tree):
            yield from _stacked_shapes(t, f"{prefix}{i}/", lead)
    elif isinstance(tree, list):
        yield from _stacked_shapes(tree[0], prefix, lead + (len(tree),))
    elif isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _stacked_shapes(tree[k], f"{prefix}{k}/", lead)
    else:
        yield prefix[:-1], lead + tuple(tree.shape)


def _restore_module(data, template: torch.nn.Module, device):
    """The leaves of the template's family (its ``init_params`` on
    ``meta``) in the stacked layout, checked, then carried into a new
    module of the template's class on ``device``."""
    cfg = template.cfg
    want, _ = _init_fn(cfg)(cfg, device="meta")
    tree: dict = {}
    for p, shape in _stacked_shapes(want):
        node = tree
        *parents, leaf = p.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = _checked(data, p, shape)
    return type(template)(cfg, model_params_from_numpy(tree, cfg,
                                                       device=device))


def _rebuild(template, arrays, device):
    if isinstance(template, Mapping):
        return {k: _rebuild(v, arrays, device) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, arrays, device) for v in template)
    arr = arrays[id(template)]
    if isinstance(template, torch.Tensor):
        dev = device if device is not None else template.device
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=dev, dtype=template.dtype)
    return arr.astype(template.dtype) if hasattr(template, "dtype") else arr


def restore_checkpoint(path: str, template: Any, *,
                       device=None) -> tuple[Any, int | None]:
    """Restore into the structure of ``template``; returns (tree, step).

    ``template`` is a zoo module (its weights may be on ``meta``: only its
    class and config are read; a new module of its class is returned) or
    a dict / list tree of tensors or numpy arrays (the same tree of the
    template's dtypes is returned).  Tensors land on ``device``, default
    the template's.
    """
    if device is not None:
        device = resolve_device(device)
    with np.load(path) as data:
        step = int(data["__step__"]) if "__step__" in data else None
        if isinstance(template, ZOO_MODULES):
            if device is None:
                device = template.embed["table"].device
            if device.type == "meta":
                raise ValueError("a template on meta needs device=")
            return _restore_module(data, template, device), step
        arrays = {id(leaf): _checked(data, p, leaf.shape)
                  for p, leaf in _leaves(template)}
    return _rebuild(template, arrays, device), step
