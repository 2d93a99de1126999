"""Shared model-building blocks: parameter specs with logical axes, norms,
embeddings, RoPE (port of ``repro/models/common.py``).

Parameters are nested dicts of tensors while they are built.  Every leaf
starts as a :class:`ParamSpec` carrying its logical axis names;
:func:`split_params` separates the value tree from the axes tree, which the
sharding slice will map onto a device mesh.  :class:`ParamTree` turns a
value tree into an ``nn.Module`` whose leaves are ``nn.Parameter``\\ s and
which indexes like the dict it came from, so the functions of
``attention.py`` / ``mlp.py`` take either.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Mapping, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from repro_torch.obs import trace


@dataclasses.dataclass
class ParamSpec:
    value: torch.Tensor
    axes: tuple[Optional[str], ...]

    def __post_init__(self):
        if len(self.axes) != self.value.ndim:
            raise ValueError(
                f"axes {self.axes} rank != value rank {tuple(self.value.shape)}")


def split_params(tree) -> tuple[Any, Any]:
    """(ParamSpec tree) -> (values tree, axes tree); lists stay lists."""
    if isinstance(tree, ParamSpec):
        return tree.value, tuple(tree.axes)
    if isinstance(tree, Mapping):
        pairs = {k: split_params(v) for k, v in tree.items()}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    if isinstance(tree, (list, tuple)):
        pairs = [split_params(v) for v in tree]
        return [p[0] for p in pairs], [p[1] for p in pairs]
    raise TypeError(f"not a parameter tree node: {type(tree).__name__}")


class Initializer:
    """Parameter factory on an explicit ``torch.Generator``.

    Scales follow the reference: ``normal`` draws N(0, 1) times
    ``1/sqrt(fan_in)`` (fan_in = first dim of a matrix) unless a scale is
    given.  The draws cannot match JAX's; parity tests carry the
    reference's parameters across with :mod:`repro_torch.convert`.  With
    ``generator=None`` every leaf is an uninitialised tensor on ``device``
    (``"meta"`` gives shapes without memory).
    """

    def __init__(self, generator: Optional[torch.Generator],
                 dtype=torch.float32, device=None):
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device(
            device if device is not None
            else (generator.device if generator is not None else "cpu"))

    def normal(self, shape, axes, scale=None):
        fan_in = shape[0] if len(shape) > 1 else shape[-1]
        if scale is None:
            scale = 1.0 / math.sqrt(max(fan_in, 1))
        if self.generator is None:
            v = torch.empty(shape, dtype=self.dtype, device=self.device)
        else:
            v = torch.randn(shape, generator=self.generator,
                            dtype=self.dtype, device=self.device) * scale
        return ParamSpec(v, axes)

    def zeros(self, shape, axes):
        return ParamSpec(torch.zeros(shape, dtype=self.dtype,
                                     device=self.device), axes)

    def ones(self, shape, axes):
        return ParamSpec(torch.ones(shape, dtype=self.dtype,
                                    device=self.device), axes)

    def const(self, value, axes):
        """``value`` (a tensor or array, computed by the caller, on any
        device) cast to the initializer's dtype and device."""
        return ParamSpec(torch.as_tensor(value).to(dtype=self.dtype,
                                                   device=self.device), axes)


class ParamTree(nn.Module):
    """A nested dict of tensors as an ``nn.Module``.

    Tensor leaves become ``nn.Parameter``\\ s, sub-dicts ``ParamTree``
    children, so ``state_dict`` names follow the dict's paths
    (``attn.wq``).  ``tree[key]`` returns the parameter or child.
    """

    def __init__(self, tree: Mapping):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, Mapping):
                self.add_module(k, ParamTree(v))
            elif isinstance(v, torch.Tensor):
                self.register_parameter(
                    k, v if isinstance(v, nn.Parameter) else nn.Parameter(
                        v, requires_grad=v.is_floating_point()))
            else:
                raise TypeError(f"{k}: not a tensor or dict "
                                f"({type(v).__name__})")

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def tensors(self) -> dict:
        """The tree as nested dicts of the tensors its attributes hold now
        (under ``torch.func.functional_call``, the substituted ones)."""
        out = {k: getattr(self, k) for k in self._parameters}
        out.update((k, m.tensors()) for k, m in self._modules.items())
        return out


# ---------------------------------------------------------------------------
# Rematerialisation
# ---------------------------------------------------------------------------

#: ops whose outputs the "dots" policy saves (the matmuls of a block)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)


def maybe_checkpoint(fn, cfg):
    """``fn`` under ``torch.utils.checkpoint`` per the config's remat policy.

    "full": save only the inputs and recompute the rest in the backward
    pass.  "dots": also save the matmul outputs (``aten.mm`` /
    ``aten.bmm``), as the reference's ``dots_with_no_batch_dims_saveable``
    policy does.  Applies only while grad is enabled.  The checkpointed
    call recomputes from the arguments it was given, so pass parameters
    as tensors (:meth:`ParamTree.tensors`), not as a module whose
    attributes a ``functional_call`` swaps back before the backward pass.
    ``torch.func`` transforms reject checkpointing (saved-tensor hooks):
    ``torch.func.grad`` of a remat config raises.  While tracing is on,
    the recompute runs in span ``remat``.
    """
    if not cfg.remat:
        return fn
    if cfg.remat_policy == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       list(_DOTS))
    elif cfg.remat_policy == "full":
        context_fn = noop_context_fn
    else:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; "
                         "have full | dots")

    body = trace.recomputed(fn)

    def wrapped(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        return checkpoint(body, *args, use_reentrant=False,
                          context_fn=context_fn, **kwargs)

    return wrapped


def cast(x, dtype):
    """``x.to(dtype)``, the model's explicit floating conversions; while
    tracing is on, a conversion that changes the dtype adds the bytes it
    reads and writes to the ``cast_bytes`` counter."""
    if x.dtype != dtype and trace.on():
        trace.count("cast_bytes",
                    x.numel() * (x.element_size() + dtype.itemsize))
    return x.to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x, weight, eps: float = 1e-6):
    """RMS norm in fp32 with a zero-centred scale (``1 + weight``)."""
    dtype = x.dtype
    x = cast(x, torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return cast(out * (1.0 + cast(weight, torch.float32)), dtype)


def init_rms_norm(ini: Initializer, dim: int):
    # stored as zero-centered scale (weight = 1 + w), friendlier to l1-prox
    return {"scale": ini.zeros((dim,), ("embed",))}


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None):
    """1 / theta^(2i / head_dim) in fp32, computed on ``device``.

    ``theta`` stays a Python number (a scalar operand of the kernel): a
    tensor made from it on the card would be a host-to-device copy, which
    blocks the host on every layer's call.
    """
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (float(theta) ** exps)


def yarn_correction_range(yarn, dim: int, theta: float) -> tuple[int, int]:
    """DeepSeek-V2's ``yarn_find_correction_range``: the rotary dims
    between ``beta_fast`` and ``beta_slow`` rotations over the original
    context, floored and ceiled, clipped to [0, dim - 1]."""
    def at(rotations):
        return (dim * math.log(yarn.original_max_position_embeddings
                               / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))
    return (max(math.floor(at(yarn.beta_fast)), 0),
            min(math.ceil(at(yarn.beta_slow)), dim - 1))


@functools.lru_cache(maxsize=None)
def _yarn_inv_freq(dim: int, theta: float, yarn, device) -> torch.Tensor:
    powers = theta ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
    extra, inter = 1.0 / powers, 1.0 / (yarn.factor * powers)
    low, high = yarn_correction_range(yarn, dim, theta)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    mask = 1.0 - ramp           # DeepSeek's inv_freq_mask, in its order
    return (inter * (1 - mask) + extra * mask).to(device)


def yarn_inv_freq(dim: int, theta: float, yarn, device=None) -> torch.Tensor:
    """(dim / 2,) fp32 inverse frequencies of YaRN RoPE, as DeepSeek-V2's
    ``DeepseekV2YarnRotaryEmbedding`` computes them: ``extra = theta^(-2i /
    dim)``, ``inter = extra / factor``, ``ramp`` linear from 0 to 1 over
    :func:`yarn_correction_range`, ``inter ramp + extra (1 - ramp)``.
    Computed once a (dim, theta, yarn, device) on the host and kept there."""
    return _yarn_inv_freq(dim, float(theta), yarn, torch.device(
        device if device is not None else "cpu"))


def apply_rope(x, positions, theta: float = 1e4, *, inv_freq=None):
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq).

    Split halves (not interleaved), computed in fp32.  ``inv_freq``
    ((head_dim / 2,), on x's device) replaces ``theta``'s frequencies
    (YaRN's, :func:`yarn_inv_freq`).
    """
    head_dim = x.shape[-1]
    freqs = (rope_frequencies(head_dim, theta, device=x.device)
             if inv_freq is None else inv_freq)                 # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs     # (..., seq, hd/2)
    angles = angles[..., None, :]                                # (..., seq, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(cast(x, torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return cast(out, x.dtype)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def init_embedding(ini: Initializer, vocab: int, d_model: int):
    return {"table": ini.normal((vocab, d_model), ("vocab", "embed"),
                                scale=0.02)}


def embed(params, tokens):
    return params["table"][tokens]


def pad_vocab(vocab: int, multiple: int = 256) -> int:
    return ((vocab + multiple - 1) // multiple) * multiple
