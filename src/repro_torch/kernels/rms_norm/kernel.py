"""RMSNorm on the card: a hand-written CUDA kernel pair, plain PyTorch beside.

Replaces no TPU kernel: the reference's ``rms_norm`` is plain ``jnp``,
which XLA fuses.  The port's plain version, ``models/common.py::rms_norm``,
runs on the card as 10 eager ops forward and 17 backward over fp32 copies
of the rows.  :func:`rms_norm_cuda` runs it as one launch forward and two
backward (``csrc/rms_norm.cu``, whose header note gives the design and the
bound), behind :class:`_RMSNorm`, an ``autograd.Function`` that saves only
x and w.  ``models/common.py::rms_norm`` takes it for every CUDA tensor;
the CPU keeps the plain path (``rms_norm_plain``), which with :mod:`.ref`'s
plain backward is what the tests hold the kernels to.

x is any (..., d) tensor in fp32 or bf16 whose last dim has unit stride
and whose leading dims flatten to evenly strided rows (:func:`row_layout`;
a ``split`` view is read in place, anything else is copied first); w is
(d,) in fp32 or bf16.  y and dx come back contiguous in x's shape and
dtype, dw in w's.  A call takes the 16-byte vector route when d, the row
strides and the pointers are whole vectors, else the element route
(:func:`plan`).

Each source is built with ``nvcc`` at first use into ``build/`` beside
this file and loaded with ``ctypes``.  Every forward adds one to
``LAUNCH_COUNTS["rms_norm_fwd"]`` and every backward (its two launches)
one to ``LAUNCH_COUNTS["rms_norm_bwd"]``.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

#: forward and backward calls launched on the card (never on the CPU)
LAUNCH_COUNTS: collections.Counter = collections.Counter()

SOURCE = Path(__file__).parent / "csrc" / "rms_norm.cu"
BUILD_DIR = Path(__file__).parent / "build"
# -Xptxas -v: each instantiation's registers and spills in the build's log
NVCC_FLAGS = _build.BASE_FLAGS + ("-Xptxas", "-v")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: elements of one 16-byte vector, the vector route's chunk
VEC = {torch.float32: 4, torch.bfloat16: 8}
#: chunks a thread holds at most by route and direction, ``(vec, bwd)``
#: (the source's Route<T, vec, bwd>::kNV), and threads a row at most
#: (kMaxTpr); rows past MAX_D elements are refused in both directions
MAX_CHUNKS = {(True, False): 4, (True, True): 2, (False, False): 16,
              (False, True): 16}
MAX_TPR = 512
MAX_D = MAX_TPR * MAX_CHUNKS[False, True]
#: threads of a forward block, and of a backward block (kBwdThreads)
FWD_THREADS, BWD_THREADS = 512, 512


def reset_launch_counts() -> None:
    LAUNCH_COUNTS.clear()


def build_library() -> Path:
    """Compile ``csrc/rms_norm.cu`` (once per source and flags) and return
    the shared library's path."""
    return _build.build_library(SOURCE, BUILD_DIR, NVCC_FLAGS)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    lib.rms_norm_occupancy.argtypes = [i, i, i, i, i]
    lib.rms_norm_fwd.argtypes = [p, ll, p, i, p, ll, i, i, i, i, i, i, f, p]
    lib.rms_norm_bwd.argtypes = [p, ll, p, ll, p, i, p, p, p, ll, i, i, i,
                                 i, i, i, f, p]
    for fn in (lib.rms_norm_occupancy, lib.rms_norm_fwd, lib.rms_norm_bwd):
        fn.restype = i
    return lib


# ---------------------------------------------------------------------------
# The launch's shape: pure functions of shapes, strides and pointers
# ---------------------------------------------------------------------------

class Plan(NamedTuple):
    vec: bool      # 16-byte vectors (else elements)
    chunk: int     # elements of a chunk: VEC[dtype] or 1
    tpr: int       # threads a row: a power of two in [4, MAX_TPR]


def row_layout(t: torch.Tensor):
    """``(rows, row stride)`` of ``t`` as rows of its last dim, or None
    when its last dim is not unit-strided or its leading dims do not
    flatten to one stride (dims of size 1 are skipped)."""
    d = t.shape[-1]
    if d > 1 and t.stride(-1) != 1:
        return None
    stride = span = None
    for size, st in zip(reversed(t.shape[:-1]), reversed(t.stride()[:-1])):
        if size == 1:
            continue
        if stride is None:
            stride = st
        elif st != span:
            return None
        span = st * size
    return t.numel() // max(d, 1), d if stride is None else stride


@functools.lru_cache(maxsize=None)
def plan(d: int, dtype: torch.dtype, vec: bool, bwd: bool) -> Plan:
    """The launch shape of the forward or the backward (``bwd``) for rows
    of ``d`` elements of ``dtype`` on the vector route (``vec``: d and the
    strides whole vectors) or the element route: the fewest threads a row
    (at least 4, a power of two) that hold the row in ``MAX_CHUNKS``
    chunks each, at most ``MAX_TPR``; a row too wide for the vector route
    (an fp32 backward past 4,096) takes the element route, and one past
    ``MAX_D`` raises.  A block of ``FWD_THREADS`` (forward) or
    ``BWD_THREADS`` (backward) threads holds several rows' threads."""
    chunk = VEC[dtype] if vec else 1
    if d <= 0 or d % chunk:
        raise ValueError(f"rms_norm: d = {d} is not whole chunks of {chunk}")
    if d > MAX_D:
        raise ValueError(f"rms_norm_cuda: rows of {d} elements exceed the "
                         f"kernels' {MAX_D}")
    need = -(-(d // chunk) // MAX_CHUNKS[vec, bwd])
    tpr = max(4, 1 << (need - 1).bit_length())
    if tpr > MAX_TPR:
        return plan(d, dtype, False, bwd)
    return Plan(vec, chunk, tpr)


def _whole_vectors(d: int, dtype, strides, ptrs) -> bool:
    n = VEC[dtype]
    return (d % n == 0 and all(s % n == 0 for s in strides)
            and all(p % 16 == 0 for p in ptrs))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _resident(dtype: torch.dtype, vec: bool, bwd: bool, threads: int,
              d: int, index: int) -> int:
    """Blocks of ``threads`` resident on the whole card (device
    ``index``) at rows of ``d``."""
    n = _lib().rms_norm_occupancy(_DTYPES[dtype], int(vec), int(bwd),
                                  threads, d)
    if n <= 0:
        raise RuntimeError(f"rms_norm occupancy query failed: error {-n}")
    return _sms(index) * n


@functools.lru_cache(maxsize=4096)
def launch_shape(d: int, dtype: torch.dtype, vec: bool, bwd: bool,
                 rows: int, index: int) -> tuple[int, int, int, int]:
    """``(vec, tpr, threads, blocks)`` of a launch: :func:`plan`'s route
    and shape, and a persistent grid of what stays resident, or fewer
    blocks where the rows run out (a backward block writes one fp32 row of
    dw partials, so the grid also bounds those bytes)."""
    p = plan(d, dtype, vec, bwd)
    threads = BWD_THREADS if bwd else FWD_THREADS
    blocks = min(-(-rows // (threads // p.tpr)),
                 _resident(dtype, p.vec, bwd, threads, d, index))
    return int(p.vec), p.tpr, threads, max(1, blocks)


# ---------------------------------------------------------------------------
# The launches
# ---------------------------------------------------------------------------

def _check(x, weight):
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm_cuda: x is on {x.device}, not CUDA")
    if x.dtype not in _DTYPES or weight.dtype not in _DTYPES:
        raise ValueError(f"rms_norm_cuda: x {x.dtype} and w {weight.dtype} "
                         "must each be float32 or bfloat16")
    if weight.shape != (x.shape[-1],) or weight.device != x.device:
        raise ValueError(f"rms_norm_cuda: w {tuple(weight.shape)} on "
                         f"{weight.device} must be ({x.shape[-1]},) on "
                         f"{x.device}")


def _rows(t):
    """``(t or its contiguous copy, rows, row stride)``."""
    d = t.shape[-1]
    if t.is_contiguous():
        return t, t.numel() // max(d, 1), d
    layout = row_layout(t)
    if layout is None:
        t = t.contiguous()
        return t, t.numel() // max(d, 1), d
    return (t, *layout)


def _run(name: str, fn, index: int, *args):
    """One ctypes call on the current stream of device ``index``, with
    that device current; raises on a CUDA error."""
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return _run(name, fn, index, *args)
    # the raw handle of PyTorch's current stream: a Python int, without
    # building a torch.cuda.Stream object on every call
    err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCH_COUNTS[name] += 1


def _fwd(x, weight, eps: float):
    x, rows, stride = _rows(x)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if rows == 0:
        return y
    d, index, xp, yp = x.shape[-1], x.device.index, x.data_ptr(), y.data_ptr()
    vec, *shape = launch_shape(d, x.dtype, _whole_vectors(
        d, x.dtype, (stride,), (xp, yp)), False, rows, index)
    _run("rms_norm_fwd", _lib().rms_norm_fwd, index, xp, stride,
         weight.contiguous().data_ptr(), _DTYPES[weight.dtype], yp, rows, d,
         _DTYPES[x.dtype], vec, *shape, eps)
    return y


def _bwd(x, weight, dy, eps: float):
    x, rows, x_stride = _rows(x)
    dy, _, dy_stride = _rows(dy)
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if rows == 0:
        return dx, torch.zeros_like(weight)
    d, index = x.shape[-1], x.device.index
    xp, dyp, dxp = x.data_ptr(), dy.data_ptr(), dx.data_ptr()
    vec, *shape = launch_shape(d, x.dtype, _whole_vectors(
        d, x.dtype, (x_stride, dy_stride), (xp, dyp, dxp)), True, rows, index)
    partial = torch.empty((shape[2], d), dtype=torch.float32,
                          device=x.device)
    dw = torch.empty(weight.shape, dtype=weight.dtype, device=x.device)
    _run("rms_norm_bwd", _lib().rms_norm_bwd, index, xp, x_stride, dyp,
         dy_stride, weight.contiguous().data_ptr(), _DTYPES[weight.dtype],
         dxp, dw.data_ptr(), partial.data_ptr(), rows, d, _DTYPES[x.dtype],
         vec, *shape, eps)
    return dx, dw


def rms_norm_fwd_cuda(x, weight, eps: float = 1e-6):
    """``y = x rsqrt(mean(x^2) + eps) (1 + w)``, one kernel launch."""
    _check(x, weight)
    return _fwd(x, weight, float(eps))


def rms_norm_bwd_cuda(x, weight, dy, eps: float = 1e-6):
    """``(dx, dw)`` for the output gradient ``dy``: one launch for dx and
    the per-block partial sums of dw, one that adds them in a fixed
    order."""
    _check(x, weight)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"rms_norm_bwd_cuda: dy {dy.dtype} "
                         f"{tuple(dy.shape)} must be x's {x.dtype} "
                         f"{tuple(x.shape)}")
    return _bwd(x, weight, dy, float(eps))


class _RMSNorm(torch.autograd.Function):
    """The kernel pair as one differentiable op; saves x and w only."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _fwd(x, weight, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw = _bwd(x, weight, dy, ctx.eps)
        return dx, dw, None


def rms_norm_cuda(x, weight, eps: float = 1e-6):
    """Differentiable RMSNorm of a CUDA tensor through the kernels; raises
    on anything else (the CPU runs ``models/common.py``'s plain path)."""
    _check(x, weight)
    return _RMSNorm.apply(x, weight, float(eps))
