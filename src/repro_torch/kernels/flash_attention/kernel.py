"""Flash attention: CUDA kernels for Hopper, plain PyTorch beside.

Port of ``repro/kernels/flash_attention/kernel.py``: :func:`flash_attention`
replaces ``flash_attention`` (``_fa_kernel``), blockwise online-softmax
attention with GQA (query head ``h`` reads kv head ``h // (H / KV)``), a
causal mask, and a sliding window that applies only when causal.  q is
``(B, Lq, H, D)``, k and v ``(B, Lk, KV, D)``, fp32 or bf16, any D up to
256.  Unlike the Pallas wrapper there is no ``Lq % block`` rule: any Lq
and Lk.

Each CUDA kernel is instantiated for the head dims of its dtype in
``HEAD_DIMS``: bf16 for 64, 80, 96, 128 and 256 (80 and 96 at their true
width: TMA boxes past D zero-filled in shared memory, P V one
``m64n80k16`` / ``m64n96k16``), fp32 for 64, 128 and 256.  Any other D <=
256 takes the head-dim route (:func:`pad_head_dim`): q, k and v
zero-padded along D to the dtype's next kernel dimension (fp32: 32 -> 64,
80 and 96 -> 128; bf16: 32 -> 64), the scale ``1 / sqrt(D)`` of the true D
passed to the same kernel, and the first D output columns returned.  That
is exact: zero columns add nothing to ``Q K^T`` and give zero output
columns.  It costs three padded copies in, one sliced copy out, and the
padded share of the kernel's work.

:func:`flash_attention` dispatches by device and dtype, with no fallback
from one route to another:

* bf16 on CUDA: ``csrc/flash_fwd_sm90.cu``, the tensor-core kernel (wgmma,
  TMA loads into a ring of shared-memory stages);
* fp32 on CUDA: ``csrc/flash_fwd.cu``, fp32 on the CUDA cores, the exact
  path the fp32 models rely on (register-tiled Q K^T and P V, K/V tiles
  streamed with ``cp.async``);
* CPU: :func:`flash_attention_plain` (any D; the route is never reached);
* anything else raises.

Training attends through :func:`flash_attention_train`, an
``autograd.Function`` of two hand-written kernels: the bf16 forward
writing each row's logsumexp (``lse``), and ``csrc/flash_bwd_sm90.cu``,
the bf16 backward, at the head dims of ``TRAIN_HEAD_DIMS`` and at the
(query/key, value) head dims of ``TRAIN_DV_PAIRS``: v's head dim may
differ from q's and k's (multi-head latent attention's 192 against 128),
and the output then has v's.  It takes a softmax ``scale`` (default
``1 / sqrt(D)`` of q's D).  On the CPU
it runs :func:`flash_attention_plain` (with ``return_lse``) and
:func:`flash_attention_bwd_plain`; a CUDA tensor launches the kernels or
raises.  :func:`trains_on_kernel` says which calls the kernels take.

Each source is built with ``nvcc`` at first use into ``build/`` next to
this file and loaded with ``ctypes``.  Every launch of
:func:`flash_attention_cuda` adds one to ``LAUNCH_COUNTS["flash_fwd"]``,
and one to the route's own count (``"flash_fwd_sm90"`` or
``"flash_fwd_fp32"``); a launch through the head-dim route also to
``"flash_fwd_padded"``.  The training forward counts under
``"flash_fwd_train"``, its backward under ``"flash_bwd"`` and
``"flash_bwd_sm90"`` (one a backward: its three kernels, Delta, dK / dV
and dQ, in one call).  The sources' header notes give the designs and the
bounds on the card.
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
#: the head dims each dtype's kernel is instantiated for
HEAD_DIMS = {torch.bfloat16: (64, 80, 96, 128, 256),
             torch.float32: (64, 128, 256)}
#: the head dims the bf16 backward is instantiated for: training on CUDA
#: attends through the kernels at these (D 256 trains through ``_sdpa``)
TRAIN_HEAD_DIMS = (64, 80, 96, 128)
#: the (q / k, v) head dims that differ and that the bf16 forward and
#: backward are instantiated for: multi-head latent attention's
TRAIN_DV_PAIRS = ((192, 128),)
_DTYPES = (torch.float32, torch.bfloat16)
_GRID_LIMIT = 65535  # gridDim.y (heads) and gridDim.z (batch)

#: kernel launches: "flash_fwd" counts every launch of
#: :func:`flash_attention_cuda`, "flash_fwd_sm90" and "flash_fwd_fp32" those
#: of each kernel, "flash_fwd_padded" those through the head-dim route;
#: "flash_fwd_train" the training forward's (bf16, with ``lse``),
#: "flash_bwd" and "flash_bwd_sm90" its backward's; a count rises only
#: where the wrapper launches a CUDA kernel (never on the plain path)
LAUNCH_COUNTS: collections.Counter = collections.Counter()

#: the CUDA source of each route, keyed by the C function it exports
SOURCES = {"flash_fwd": Path(__file__).parent / "csrc" / "flash_fwd.cu",
           "flash_fwd_sm90": Path(__file__).parent / "csrc"
           / "flash_fwd_sm90.cu",
           "flash_bwd_sm90": Path(__file__).parent / "csrc"
           / "flash_bwd_sm90.cu"}
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


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: each C function's arguments: pointers, then B, Lq, Lk, H, KV, D (and
#: v's DV for the bf16 kernels), then scale, causal, window and the stream
_ARGTYPES = {"flash_fwd": [_P] * 4 + [_I] * 6 + [_F, _I, _I, _P],
             # q, k, v, o, lse
             "flash_fwd_sm90": [_P] * 5 + [_I] * 7 + [_F, _I, _I, _P],
             # q, k, v, o, dout, lse, delta, dq, dk, dv
             "flash_bwd_sm90": [_P] * 10 + [_I] * 7 + [_F, _I, _I, _P]}


@functools.lru_cache(maxsize=None)
def _kernel(name: str):
    """The C function ``name`` of its built library."""
    fn = getattr(ctypes.CDLL(str(build_library(name))), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = _I
    return fn


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention: q, k, v must be (B, L, heads, D)")
    B, Lq, H, D = q.shape
    if k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be (B, Lk, KV, D) and "
                         f"(B, Lk, KV, DV) with q's B = {B} and D = {D}")
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


def padded_head_dim(D: int, dtype: torch.dtype) -> int:
    """The kernel head dim that serves ``D`` in ``dtype``: the least of
    ``HEAD_DIMS[dtype]`` not below it."""
    if D < 1:
        raise ValueError(f"flash_attention: head dim {D}")
    dims = HEAD_DIMS[dtype]
    for kd in dims:
        if D <= kd:
            return kd
    raise ValueError(f"flash_attention: head dim {D} exceeds {dims[-1]}, "
                     "the widest kernel instantiation")


def pad_head_dim(fn, q, k, v, *, causal: bool = True, window: int = 0):
    """``fn`` (a flash function taking ``scale=``) on q, k, v zero-padded
    along D to :func:`padded_head_dim` of their dtype, with the true D's
    scale; returns the first D columns of its output, contiguous."""
    D = q.shape[-1]
    width = padded_head_dim(D, q.dtype) - D
    q, k, v = (torch.nn.functional.pad(t, (0, width)) for t in (q, k, v))
    out = fn(q, k, v, causal=causal, window=window, scale=1.0 / math.sqrt(D))
    return out[..., :D].contiguous()


def _visible(Lq: int, Lk: int, causal: bool, window: int, device):
    """(Lq, Lk) True where query i sees key j."""
    i = torch.arange(Lq, device=device)[:, None]
    j = torch.arange(Lk, device=device)[None, :]
    mask = torch.ones((Lq, Lk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (j <= i)
        if window > 0:
            mask = mask & (j > i - window)
    return mask


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          scale: float | None = None,
                          return_lse: bool = False):
    """Plain PyTorch version of :func:`flash_attention_cuda`; ``scale``
    defaults to ``1 / sqrt(D)``.  v's head dim may differ from q's and k's
    D: the output has v's.  With ``return_lse`` it returns ``(out,
    lse)``: ``lse`` (B, H, Lq) fp32, each row's logsumexp of its scaled
    visible scores, ``+inf`` for a row with no visible key (so that
    ``exp(s - lse)`` is 0 there), as the bf16 kernel writes it.

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
    mask = _visible(Lq, Lk, causal, window, q.device)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    seen = mask.any(dim=-1, keepdim=True)
    probs = torch.where(seen, probs, 0.0)
    out = torch.einsum("bkgij,bjkd->bikgd", probs, v.to(torch.float32))
    out = out.reshape(B, Lq, H, v.shape[3]).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(seen[..., 0], torch.logsumexp(scores, dim=-1),
                      math.inf)
    return out, lse.reshape(B, H, Lq)


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              window: int = 0, scale: float | None = None):
    """Plain PyTorch version of the backward (:func:`flash_attention_bwd_cuda`),
    in fp32 whatever the storage type: ``(dq, dk, dv)`` in q's dtype.

    ``o`` is the forward's output and ``lse`` its (B, H, Lq) row logsumexp
    (``flash_attention_plain(..., return_lse=True)``; the kernel's padded
    rows do too, of which the first Lq are read); ``do`` the gradient of
    ``o``.  The kernel's arithmetic: ``P = exp(S scale - lse)`` on the
    visible pairs (0 elsewhere, and on a row whose ``lse`` is ``+inf``),
    ``Delta = rowsum(dO o)``, ``dS = P (dO V^T - Delta)``; ``dV = P^T
    dO``, ``dK = scale dS^T Q`` (both summed over the query heads of a kv
    head's group), ``dQ = scale dS K``; ``scale`` defaults to ``1 /
    sqrt(D)``.  o and do have v's head dim DV, which may differ from q's.
    """
    _check(q, k, v)
    B, Lq, H, D = q.shape
    Lk, KV, DV = k.shape[1], k.shape[2], v.shape[3]
    G = H // KV
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    f32 = lambda t: t.to(torch.float32)
    qg = f32(q).reshape(B, Lq, KV, G, D)
    dog = f32(do).reshape(B, Lq, KV, G, DV)
    kf, vf = f32(k), f32(v)
    s = torch.einsum("bikgd,bjkd->bkgij", qg, kf) * scale
    mask = _visible(Lq, Lk, causal, window, q.device)
    rows = f32(lse)[..., :Lq].reshape(B, KV, G, Lq, 1)
    p = torch.where(mask, torch.exp(s - rows), 0.0)
    delta = torch.sum(dog * f32(o).reshape(B, Lq, KV, G, DV), dim=-1)
    dp = torch.einsum("bikgd,bjkd->bkgij", dog, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dv = torch.einsum("bkgij,bikgd->bjkd", p, dog)
    dk = torch.einsum("bkgij,bikgd->bjkd", ds, qg) * scale
    dq = torch.einsum("bkgij,bjkd->bikgd", ds, kf) * scale
    return (dq.reshape(B, Lq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0):
    """The CUDA kernel of q's dtype on contiguous CUDA tensors: bf16 runs
    ``flash_fwd_sm90.cu`` (tensor cores), fp32 ``flash_fwd.cu``.  A head
    dim not in ``HEAD_DIMS`` of the dtype (up to 256) takes the head-dim
    route.  v's head dim is q's (it differs only in training)."""
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda: tensors on {q.device}, "
                         "not a CUDA device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_cuda: {name} must be "
                             "contiguous")
    D = q.shape[3]
    if v.shape[3] != D:
        raise ValueError(f"flash_attention_cuda: v's head dim {v.shape[3]} "
                         f"differs from q's {D}: only the training kernels "
                         f"take that ({TRAIN_DV_PAIRS})")
    if D in HEAD_DIMS[q.dtype]:
        return _launch(q, k, v, causal=causal, window=window,
                       scale=1.0 / math.sqrt(D))
    return pad_head_dim(functools.partial(_launch, padded=True), q, k, v,
                        causal=causal, window=window)


def _launch(q, k, v, *, causal: bool, window: int, scale: float,
            padded: bool = False, lse=None):
    """One launch of the kernel of q's dtype at a D of its ``HEAD_DIMS``;
    ``lse`` (bf16 only: fp32 (B, H, :func:`lse_rows` (Lq))) also receives
    each row's logsumexp, and the launch counts as the training
    forward's."""
    B, Lq, H, D = q.shape
    Lk, KV, DV = k.shape[1], k.shape[2], v.shape[3]
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
    out = q.new_empty((B, Lq, H, DV))
    if out.numel() == 0 or Lk == 0:
        # nothing to launch: no row, or no key (every row 0, lse +inf)
        if lse is not None:
            lse.fill_(math.inf)
        return out.zero_()
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    dims = [B, Lq, Lk, H, KV, D]
    if fn_name == "flash_fwd_sm90":
        ptrs.append(None if lse is None else lse.data_ptr())
        dims.append(DV)
    fn = _kernel(fn_name)
    with torch.cuda.device(q.device):
        err = fn(*ptrs, *dims, scale, int(causal), int(window),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: error {err} (a CUDA "
                           "error, or 1000 + a CUresult of the TMA "
                           "descriptor)")
    if lse is not None:
        LAUNCH_COUNTS["flash_fwd_train"] += 1
        return out
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


# ---------------------------------------------------------------------------
# Training: the forward with its row logsumexp, and the backward
# ---------------------------------------------------------------------------

#: the kernels' q tile: ``lse`` and Delta hold this many rows' multiple
_LSE_TILE = 128


def lse_rows(Lq: int) -> int:
    """Rows of the kernels' ``lse`` and Delta buffers: Lq padded to whole
    q tiles (the padding holds ``+inf`` and 0)."""
    return -(-Lq // _LSE_TILE) * _LSE_TILE


def trains_on_kernel(q, v=None) -> bool:
    """Whether :func:`flash_attention_train` of this ``q`` (and ``v``,
    where its head dim differs) launches the kernels: a CUDA tensor in bf16
    at a head dim of ``TRAIN_HEAD_DIMS``, or at a (q, v) pair of
    ``TRAIN_DV_PAIRS``."""
    if q.device.type != "cuda" or q.dtype != torch.bfloat16:
        return False
    if v is not None and v.shape[-1] != q.shape[-1]:
        return (q.shape[-1], v.shape[-1]) in TRAIN_DV_PAIRS
    return q.shape[-1] in TRAIN_HEAD_DIMS


def _check_train_cuda(fn: str, q, k, v, *more):
    _check(q, k, v)
    if not trains_on_kernel(q, v):
        raise ValueError(f"{fn}: the training kernels take CUDA bf16 at D "
                         f"in {TRAIN_HEAD_DIMS} or (D, DV) in "
                         f"{TRAIN_DV_PAIRS}, not {q.dtype} at D = "
                         f"{q.shape[-1]}, DV = {v.shape[-1]} on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v), *more):
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, q on "
                             f"{q.device}")
        if t.data_ptr() % 16:  # TMA reads from 16-byte aligned addresses
            raise ValueError(f"{fn}: {name} is not 16-byte aligned")


def flash_attention_fwd_train_cuda(q, k, v, *, causal: bool = True,
                                   window: int = 0,
                                   scale: float | None = None):
    """The bf16 forward kernel with its row logsumexp: ``(out, lse)``,
    ``lse`` the kernel's fp32 (B, H, :func:`lse_rows` (Lq)) buffer, whose
    rows past Lq hold ``+inf``; the backward kernel takes it as it is.
    ``scale`` defaults to ``1 / sqrt(D)``."""
    _check_train_cuda("flash_attention_fwd_train_cuda", q, k, v)
    B, Lq, H, D = q.shape
    lse = torch.empty((B, H, lse_rows(Lq)), dtype=torch.float32,
                      device=q.device)
    out = _launch(q, k, v, causal=causal, window=window,
                  scale=1.0 / math.sqrt(D) if scale is None else scale,
                  lse=lse)
    return out, lse


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, causal: bool = True,
                             window: int = 0, scale: float | None = None):
    """``(dq, dk, dv)`` of the bf16 backward kernel
    (``csrc/flash_bwd_sm90.cu``: Delta, then dK / dV, then dQ, in one
    call); ``o`` and ``lse`` (its padded buffer) from
    :func:`flash_attention_fwd_train_cuda`, ``do`` the gradient of
    ``o``; ``scale`` as the forward's (default ``1 / sqrt(D)``)."""
    do = do.contiguous()
    _check_train_cuda("flash_attention_bwd_cuda", q, k, v, ("o", o),
                      ("do", do), ("lse", lse))
    B, Lq, H, D = q.shape
    Lk, KV, DV = k.shape[1], k.shape[2], v.shape[3]
    if o.shape != (B, Lq, H, DV) or do.shape != o.shape or not (
            o.dtype == do.dtype == q.dtype):
        raise ValueError("flash_attention_bwd_cuda: o and do must be "
                         f"{(B, Lq, H, DV)} {q.dtype}")
    rows = (B, H, lse_rows(Lq))
    if lse.shape != rows or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd_cuda: lse must be the "
                         f"forward's fp32 {rows}, not {lse.dtype} "
                         f"{tuple(lse.shape)}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or Lk == 0:  # nothing to launch: zero gradients
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty_like(lse)
    fn = _kernel("flash_bwd_sm90")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Lq, Lk, H,
                 KV, D, DV, 1.0 / math.sqrt(D) if scale is None else scale,
                 int(causal), int(window),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_sm90 launch failed: error {err} (a "
                           "CUDA error, or 1000 + a CUresult of the TMA "
                           "descriptor)")
    LAUNCH_COUNTS["flash_bwd"] += 1
    LAUNCH_COUNTS["flash_bwd_sm90"] += 1
    return dq, dk, dv


class _FlashAttentionTrain(torch.autograd.Function):
    """Attention whose backward recomputes the probabilities from the
    forward's row logsumexp: the kernels on CUDA, the plain versions on
    the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        if q.device.type == "cuda":
            out, lse = flash_attention_fwd_train_cuda(
                q, k, v, causal=causal, window=window, scale=scale)
        else:
            out, lse = flash_attention_plain(q, k, v, causal=causal,
                                             window=window, scale=scale,
                                             return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = (flash_attention_bwd_cuda if q.device.type == "cuda"
               else flash_attention_bwd_plain)
        dq, dk, dv = bwd(q, k, v, out, lse, do, causal=ctx.causal,
                         window=ctx.window, scale=ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention_train(q, k, v, *, causal: bool = True, window: int = 0,
                          scale: float | None = None):
    """Differentiable attention for training: q (B, Lq, H, D); k
    (B, Lk, KV, D), v (B, Lk, KV, DV) -> (B, Lq, H, DV), softmax over the
    scores times ``scale`` (default ``1 / sqrt(D)``).

    On CUDA the bf16 kernels at a D of ``TRAIN_HEAD_DIMS`` or a (D, DV) of
    ``TRAIN_DV_PAIRS`` (anything else raises); on the CPU
    :func:`flash_attention_plain` forward and
    :func:`flash_attention_bwd_plain` backward; any other device raises.
    Under remat the recompute runs the forward again, ``lse`` included.
    """
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention_train: no kernel for device "
                         f"{q.device}")
    q, k, v = (t.contiguous() for t in (q, k, v))
    return _FlashAttentionTrain.apply(q, k, v, causal, int(window), scale)
