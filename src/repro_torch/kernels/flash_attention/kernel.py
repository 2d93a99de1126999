"""Flash-attention forward: CUDA kernels for Hopper, plain PyTorch beside.

Port of ``repro/kernels/flash_attention/kernel.py``: :func:`flash_attention`
replaces ``flash_attention`` (``_fa_kernel``), blockwise online-softmax
attention with GQA (query head ``h`` reads kv head ``h // (H / KV)``), a
causal mask, and a sliding window that applies only when causal.  q is
``(B, Lq, H, D)``, k and v ``(B, Lk, KV, D)``, fp32 or bf16, any D up to
256.  Unlike the Pallas wrapper there is no ``Lq % block`` rule: any Lq
and Lk.

Both CUDA kernels are instantiated for D in ``HEAD_DIMS`` (64, 128, 256).
Any other D <= 256 takes the head-dim route (:func:`pad_head_dim`): q, k
and v zero-padded along D to the next kernel dimension (32 -> 64; 80 and
96 -> 128), the scale ``1 / sqrt(D)`` of the true D passed to the same
kernel, and the first D output columns returned.  That is exact: zero
columns add nothing to ``Q K^T`` and give zero output columns.  It wastes
the padded share of the tensor-core work (37.5% at D 80, 25% at D 96).

:func:`flash_attention` dispatches by device and dtype, with no fallback
from one route to another:

* bf16 on CUDA: ``csrc/flash_fwd_sm90.cu``, the tensor-core kernel (wgmma,
  TMA loads into a ring of shared-memory stages);
* fp32 on CUDA: ``csrc/flash_fwd.cu``, fp32 on the CUDA cores, the exact
  path the fp32 models rely on (register-tiled Q K^T and P V, K/V tiles
  streamed with ``cp.async``);
* CPU: :func:`flash_attention_plain` (any D; the route is never reached);
* anything else raises.

Each source is built with ``nvcc`` at first use into ``build/`` next to
this file and loaded with ``ctypes``.  Every launch adds one to
``LAUNCH_COUNTS["flash_fwd"]``, and one to the route's own count
(``"flash_fwd_sm90"`` or ``"flash_fwd_fp32"``); a launch through the
head-dim route also to ``"flash_fwd_padded"``.  The sources' header notes
give the designs and the bounds on the card.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)
_GRID_LIMIT = 65535  # gridDim.y (heads) and gridDim.z (batch)

#: kernel launches: "flash_fwd" counts every launch, "flash_fwd_sm90" and
#: "flash_fwd_fp32" those of each kernel, "flash_fwd_padded" those through
#: the head-dim route; a count rises only where the wrapper launches a CUDA
#: kernel (never on the plain path)
LAUNCH_COUNTS: collections.Counter = collections.Counter()

#: the CUDA source of each route, keyed by the C function it exports
SOURCES = {"flash_fwd": Path(__file__).parent / "csrc" / "flash_fwd.cu",
           "flash_fwd_sm90": Path(__file__).parent / "csrc"
           / "flash_fwd_sm90.cu"}
BUILD_DIR = Path(__file__).parent / "build"
# -Xptxas -v: registers, shared memory and spills per instantiation, kept
# in the build log
NVCC_FLAGS = _build.BASE_FLAGS + ("-Xptxas", "-v")


def reset_launch_counts() -> None:
    LAUNCH_COUNTS.clear()


def build_library(name: str) -> Path:
    """Compile ``SOURCES[name]`` (once per source and flags) and return the
    shared library's path."""
    return _build.build_library(SOURCES[name], BUILD_DIR, NVCC_FLAGS)


@functools.lru_cache(maxsize=None)
def _kernel(name: str):
    """The C function ``name`` of its built library; both sources export
    the same signature."""
    fn = getattr(ctypes.CDLL(str(build_library(name))), name)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p] * 4 + [i] * 6 + [f, i, i, p]
    fn.restype = i
    return fn


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention: q, k, v must be (B, L, heads, D)")
    B, Lq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be (B, Lk, KV, D) with q's "
                         f"B = {B} and D = {D}")
    KV = k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"flash_attention: {H} query heads do not group "
                         f"over {KV} kv heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention: q, k, v differ in dtype")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not in "
                        f"{sorted(map(str, _DTYPES))}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v differ in device")


def padded_head_dim(D: int) -> int:
    """The kernel head dim that serves ``D``: the least of ``HEAD_DIMS``
    not below it."""
    if D < 1:
        raise ValueError(f"flash_attention: head dim {D}")
    for kd in HEAD_DIMS:
        if D <= kd:
            return kd
    raise ValueError(f"flash_attention: head dim {D} exceeds "
                     f"{HEAD_DIMS[-1]}, the widest kernel instantiation")


def pad_head_dim(fn, q, k, v, *, causal: bool = True, window: int = 0):
    """``fn`` (a flash function taking ``scale=``) on q, k, v zero-padded
    along D to :func:`padded_head_dim`, with the true D's scale; returns
    the first D columns of its output, contiguous."""
    D = q.shape[-1]
    width = padded_head_dim(D) - D
    q, k, v = (torch.nn.functional.pad(t, (0, width)) for t in (q, k, v))
    out = fn(q, k, v, causal=causal, window=window, scale=1.0 / math.sqrt(D))
    return out[..., :D].contiguous()


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          scale: float | None = None):
    """Plain PyTorch version of :func:`flash_attention_cuda`; ``scale``
    defaults to ``1 / sqrt(D)``.

    ``ref.py::attention_ref``'s operations, computed in fp32 whatever the
    storage type (as ``_fa_kernel`` and the fp32 kernel do; the ref rounds
    the probabilities to bf16 before P V, the bf16 kernel its un-normalised
    probabilities), cast back once.  A row
    with no visible key comes out 0, as the kernels' fully-masked-row
    guards make it (the ref would average V over it); such rows exist only
    when ``causal`` and ``Lq > Lk + window - 1`` with a window.
    """
    _check(q, k, v)
    B, Lq, H, D = q.shape
    Lk, KV = k.shape[1], k.shape[2]
    qg = q.to(torch.float32).reshape(B, Lq, KV, H // KV, D)
    scores = torch.einsum("bikgd,bjkd->bkgij", qg, k.to(torch.float32))
    if scale is None:
        scores = scores / torch.sqrt(torch.tensor(D, dtype=torch.float32))
    else:
        scores = scores * scale
    i = torch.arange(Lq, device=q.device)[:, None]
    j = torch.arange(Lk, device=q.device)[None, :]
    mask = torch.ones((Lq, Lk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (j <= i)
        if window > 0:
            mask = mask & (j > i - window)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(mask.any(dim=-1, keepdim=True), probs, 0.0)
    out = torch.einsum("bkgij,bjkd->bikgd", probs, v.to(torch.float32))
    return out.reshape(B, Lq, H, D).to(q.dtype)


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0):
    """The CUDA kernel of q's dtype on contiguous CUDA tensors: bf16 runs
    ``flash_fwd_sm90.cu`` (tensor cores), fp32 ``flash_fwd.cu``.  A head
    dim not in ``HEAD_DIMS`` (up to 256) takes the head-dim route."""
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda: tensors on {q.device}, "
                         "not a CUDA device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_cuda: {name} must be "
                             "contiguous")
    D = q.shape[3]
    if D in HEAD_DIMS:
        return _launch(q, k, v, causal=causal, window=window,
                       scale=1.0 / math.sqrt(D))
    return pad_head_dim(functools.partial(_launch, padded=True), q, k, v,
                        causal=causal, window=window)


def _launch(q, k, v, *, causal: bool, window: int, scale: float,
            padded: bool = False):
    """One launch of the kernel of q's dtype at a D of ``HEAD_DIMS``."""
    B, Lq, H, D = q.shape
    Lk, KV = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16:
        # TMA reads from 16-byte aligned addresses only
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"flash_attention_cuda: {name} is not "
                                 "16-byte aligned")
        fn_name, route = "flash_fwd_sm90", "flash_fwd_sm90"
    else:
        if B > _GRID_LIMIT or H > _GRID_LIMIT:
            raise ValueError(f"flash_attention_cuda: B = {B} or H = {H} "
                             f"exceeds the grid limit {_GRID_LIMIT}")
        fn_name, route = "flash_fwd", "flash_fwd_fp32"
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if Lk == 0:  # no key: every row is 0, nothing to launch
        return out.zero_()
    fn = _kernel(fn_name)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                 Lq, Lk, H, KV, D, scale, int(causal), int(window),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: error {err} (a CUDA "
                           "error, or 1000 + a CUresult of the TMA "
                           "descriptor)")
    LAUNCH_COUNTS["flash_fwd"] += 1
    LAUNCH_COUNTS[route] += 1
    if padded:
        LAUNCH_COUNTS["flash_fwd_padded"] += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Lq, H, D); k, v: (B, Lk, KV, D) -> (B, Lq, H, D).

    CUDA tensors launch the kernel (:func:`flash_attention_cuda`), CPU
    tensors run :func:`flash_attention_plain`; any other device raises.
    """
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")
