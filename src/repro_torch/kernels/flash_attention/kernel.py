"""Flash-attention forward: a CUDA kernel for Hopper, plain PyTorch beside.

Port of ``repro/kernels/flash_attention/kernel.py``:
:func:`flash_attention_cuda` replaces ``flash_attention`` (``_fa_kernel``),
blockwise online-softmax attention with GQA (query head ``h`` reads kv head
``h // (H / KV)``), a causal mask, and a sliding window that applies only
when causal.  q is ``(B, Lq, H, D)``, k and v ``(B, Lk, KV, D)``, fp32 or
bf16 (fp32 inside), D in {64, 128, 256}.  Unlike the Pallas wrapper there
is no ``Lq % block`` rule: any Lq and Lk.

:func:`flash_attention` dispatches: a CUDA tensor launches the kernel in
``csrc/flash_fwd.cu`` (built with ``nvcc`` at first use into ``build/``
next to this file, loaded with ``ctypes``) or raises; a CPU tensor runs
:func:`flash_attention_plain`.  Each launch adds one to
``LAUNCH_COUNTS["flash_fwd"]``.  The source's header note gives the design
and the bound on the card.
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
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_LIMIT = 65535  # gridDim.y (heads) and gridDim.z (batch)

#: kernel launches, keyed "flash_fwd"; a count rises only where the wrapper
#: launches its CUDA kernel (never on the plain path)
LAUNCH_COUNTS: collections.Counter = collections.Counter()

SOURCE = Path(__file__).parent / "csrc" / "flash_fwd.cu"
BUILD_DIR = Path(__file__).parent / "build"
# -Xptxas -v: registers, shared memory and spills per instantiation, kept
# in the build log
NVCC_FLAGS = _build.BASE_FLAGS + ("-Xptxas", "-v")


def reset_launch_counts() -> None:
    LAUNCH_COUNTS.clear()


def build_library() -> Path:
    """Compile ``csrc/flash_fwd.cu`` (once per source and flags) and return
    the shared library's path."""
    return _build.build_library(SOURCE, BUILD_DIR, NVCC_FLAGS)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_fwd.argtypes = [p] * 4 + [i] * 7 + [f, i, i, p]
    lib.flash_fwd.restype = i
    return lib


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


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0):
    """Plain PyTorch version of :func:`flash_attention_cuda`.

    ``ref.py::attention_ref``'s operations, computed in fp32 whatever the
    storage type (as the kernel, and ``_fa_kernel`` before it, do: the ref
    rounds the probabilities to bf16 before P V), cast back once.  A row
    with no visible key comes out 0, as the kernels' fully-masked-row
    guards make it (the ref would average V over it); such rows exist only
    when ``causal`` and ``Lq > Lk + window - 1`` with a window.
    """
    _check(q, k, v)
    B, Lq, H, D = q.shape
    Lk, KV = k.shape[1], k.shape[2]
    qg = q.to(torch.float32).reshape(B, Lq, KV, H // KV, D)
    scores = torch.einsum("bikgd,bjkd->bkgij", qg, k.to(torch.float32))
    scores = scores / torch.sqrt(torch.tensor(D, dtype=torch.float32))
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
    """The CUDA kernel on contiguous CUDA tensors; see the module note."""
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda: tensors on {q.device}, "
                         "not a CUDA device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_cuda: {name} must be "
                             "contiguous")
    B, Lq, H, D = q.shape
    Lk, KV = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {D} not in "
                         f"{HEAD_DIMS}")
    if B > _GRID_LIMIT or H > _GRID_LIMIT:
        raise ValueError(f"flash_attention_cuda: B = {B} or H = {H} exceeds "
                         f"the grid limit {_GRID_LIMIT}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Lq,
            Lk, H, KV, D, _DTYPES[q.dtype], 1.0 / math.sqrt(D), int(causal),
            int(window), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err}")
    LAUNCH_COUNTS["flash_fwd"] += 1
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
