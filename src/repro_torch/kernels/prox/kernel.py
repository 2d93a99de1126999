"""DEPOSITUM prox and update kernels: CUDA for Hopper, plain PyTorch beside.

Port of ``repro/kernels/prox/kernel.py``.  The sweep-major pair:

* :func:`fused_update_sweep_cuda` replaces ``fused_update_sweep_pallas``
  (``_fused_sweep_kernel``): ``nu' = gamma nu + (1 - gamma) y`` and
  ``x' = prox_{alpha h}(x - alpha nu')`` for h in l1 | mcp | scad;
* :func:`fused_tracking_sweep_cuda` replaces ``fused_tracking_sweep_pallas``
  (``_tracking_sweep_kernel``): ``y' = y + beta (g_new - g_old)``, and when
  gated ``g_kept = where(live, g_new, g_old)``.

and the one-config pair:

* :func:`prox_cuda` replaces ``prox_pallas`` (``_prox_kernel``): the
  standalone elementwise prox of a leaf of any shape;
* :func:`fused_update_cuda` replaces ``fused_update_pallas``
  (``_fused_kernel``): the fused momentum + prox update of one config,
  which is the sweep kernel's ungated instantiation on a ``(1, 1, n)``
  view.  Both take ``lam, theta, alpha[, gamma]`` as Python floats or 0-d
  tensors; they travel to the kernel as a (1, 5) table row on the
  operand's device, so a new value never rebuilds and a device tensor is
  never read back.

Sweep operands are ``(S, C, *p)`` tensors (S stacked configs, C clients), the
hyperparameters an ``(S, 5)`` float32 table ``[lam, theta, alpha, gamma,
beta]`` on the operands' device, the optional cohort gate an ``(S, C)``
float32 mask whose rows ``<= 0`` come back bit for bit unchanged.

A CUDA tensor launches the kernel in ``csrc/prox_sweep.cu`` (built with
``nvcc`` at first use into ``build/`` next to this file, loaded with
``ctypes``) or raises; a CPU tensor runs the plain PyTorch version
(``*_plain``) of the same function.  The source's header note gives the
design and the bound on the card.  Each launch adds one to
``LAUNCH_COUNTS``.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from pathlib import Path

import torch

from repro_torch._device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.prox.ref import fused_update_ref, prox_ref

# params-table column order (shared with ops.py / depositum.step)
PARAM_COLS = ("lam", "theta", "alpha", "gamma", "beta")

KINDS = {"l1": 0, "mcp": 1, "scad": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches, keyed "fused_sweep" / "tracking_sweep" / "prox" /
#: "fused_update"; a count rises only where a wrapper launches its CUDA
#: kernel (never on the plain path)
LAUNCH_COUNTS: collections.Counter = collections.Counter()

SOURCE = Path(__file__).parent / "csrc" / "prox_sweep.cu"
BUILD_DIR = Path(__file__).parent / "build"
# -fmad=false: one rounding per operation, as in the plain version
NVCC_FLAGS = _build.BASE_FLAGS + ("-fmad=false",)


def reset_launch_counts() -> None:
    LAUNCH_COUNTS.clear()


def sweep_params_table(lam, theta, alpha, gamma, beta=0.0, *,
                       device="cuda") -> torch.Tensor:
    """(S, 5) float32 params table from scalars or stacked (S,) values."""
    cols = [torch.as_tensor(v, dtype=torch.float32).reshape(-1)
            for v in (lam, theta, alpha, gamma, beta)]
    S = max(int(c.shape[0]) for c in cols)
    cols = [c.cpu().expand(S) for c in cols]
    return torch.stack(cols, dim=-1).to(resolve_device(device))


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------

def build_library() -> Path:
    """Compile ``csrc/prox_sweep.cu`` (once per source and flags) and
    return the shared library's path."""
    return _build.build_library(SOURCE, BUILD_DIR, NVCC_FLAGS)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.prox_sweep_update.argtypes = [p] * 7 + [i, i, ll, i, i, i, p]
    lib.prox_sweep_update.restype = i
    lib.prox_sweep_tracking.argtypes = [p] * 7 + [i, i, ll, i, i, p]
    lib.prox_sweep_tracking.restype = i
    lib.prox_apply.argtypes = [p] * 3 + [ll, i, i, i, p]
    lib.prox_apply.restype = i
    return lib


# ---------------------------------------------------------------------------
# Checks shared by the kernel and its plain version
# ---------------------------------------------------------------------------

def _check(name, operands, params, mask):
    a = operands[0]
    if a.ndim < 2:
        raise ValueError(f"{name}: operands must be (S, C, ...), got "
                         f"{tuple(a.shape)}")
    for o in operands:
        if o.shape != a.shape or o.dtype != a.dtype or o.device != a.device:
            raise ValueError(f"{name}: operands differ in shape, dtype or "
                             "device")
        if not o.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if a.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {a.dtype} not in "
                        f"{sorted(map(str, _DTYPES))}")
    S, C = a.shape[:2]
    for label, t, shape in (("params", params, (S, 5)),
                            ("mask", mask, (S, C))):
        if t is None:
            continue
        if (t.shape != shape or t.dtype != torch.float32
                or t.device != a.device or not t.is_contiguous()):
            raise ValueError(
                f"{name}: {label} must be a contiguous float32 {shape} "
                f"tensor on {a.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {a.device}")


def _leaf_size(a: torch.Tensor) -> int:
    d = 1
    for n in a.shape[2:]:
        d *= int(n)
    return d


def _vec_ok(d: int, *tensors) -> int:
    """float4 loads need fp32, d % 4 == 0 and 16-byte-aligned rows."""
    return int(tensors[0].dtype == torch.float32 and d % 4 == 0
               and all(t.data_ptr() % 16 == 0 for t in tensors))


def _col(params: torch.Tensor, j: int, ndim: int) -> torch.Tensor:
    """Column j of the table as (S, 1, ...) for broadcasting."""
    return params[:, j].reshape((-1,) + (1,) * (ndim - 1))


def _live(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return (mask > 0).reshape(mask.shape + (1,) * (ndim - 2))


def _stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# Fused momentum + prox update
# ---------------------------------------------------------------------------

def fused_update_sweep_plain(x, y, nu, params, mask=None, *, kind="l1"):
    """Plain PyTorch version of :func:`fused_update_sweep_cuda`.

    Computes in float32 whatever the storage type, then casts back, as the
    kernel does.  Returns (x', nu').
    """
    _check("fused_update_sweep", (x, y, nu), params, mask)
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {sorted(KINDS)}, got {kind!r}")
    f = lambda t: t.to(torch.float32)
    nd = x.ndim
    lam, theta, alpha, gamma = (_col(params, j, nd) for j in range(4))
    x_next, nu_next = fused_update_ref(f(x), f(y), f(nu), lam, alpha, gamma,
                                       prox_kind=kind, theta=theta)
    x_next, nu_next = x_next.to(x.dtype), nu_next.to(nu.dtype)
    if mask is not None:
        live = _live(mask, nd)
        x_next = torch.where(live, x_next, x)
        nu_next = torch.where(live, nu_next, nu)
    return x_next, nu_next


def fused_update_sweep_cuda(x, y, nu, params, mask=None, *, kind="l1"):
    """Sweep-major fused momentum + prox update.  Returns (x', nu').

    ``x``/``y``/``nu``: contiguous (S, C, *p) fp32 or bf16; ``params``: the
    (S, 5) table; ``mask``: optional (S, C) gate.  CUDA tensors launch the
    kernel, CPU tensors run :func:`fused_update_sweep_plain`.
    """
    if x.device.type != "cuda":
        return fused_update_sweep_plain(x, y, nu, params, mask, kind=kind)
    _check("fused_update_sweep", (x, y, nu), params, mask)
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {sorted(KINDS)}, got {kind!r}")
    xo, nuo = torch.empty_like(x), torch.empty_like(nu)
    S, C = x.shape[:2]
    d = _leaf_size(x)
    if xo.numel() == 0:
        return xo, nuo
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.prox_sweep_update(
            x.data_ptr(), y.data_ptr(), nu.data_ptr(), params.data_ptr(),
            None if mask is None else mask.data_ptr(),
            xo.data_ptr(), nuo.data_ptr(), S, C, d, KINDS[kind],
            _DTYPES[x.dtype], _vec_ok(d, x, y, nu, xo, nuo),
            _stream_ptr(x.device))
    if err != 0:
        raise RuntimeError(f"prox_sweep_update launch failed: CUDA error {err}")
    LAUNCH_COUNTS["fused_sweep"] += 1
    return xo, nuo


# ---------------------------------------------------------------------------
# Gradient-tracking axpy
# ---------------------------------------------------------------------------

def fused_tracking_sweep_plain(y, g_new, g_old, params, mask=None):
    """Plain PyTorch version of :func:`fused_tracking_sweep_cuda`.
    Returns (y', g_kept)."""
    _check("fused_tracking_sweep", (y, g_new, g_old), params, mask)
    f = lambda t: t.to(torch.float32)
    beta = _col(params, 4, y.ndim)
    y_next = (f(y) + beta * (f(g_new) - f(g_old))).to(y.dtype)
    if mask is None:
        return y_next, g_new
    live = _live(mask, y.ndim)
    return torch.where(live, y_next, y), torch.where(live, g_new, g_old)


def fused_tracking_sweep_cuda(y, g_new, g_old, params, mask=None):
    """Sweep-major tracking axpy.  Returns (y', g_kept).

    Same layout contract as :func:`fused_update_sweep_cuda`; ``beta`` is
    column 4 of the table.  Without a mask ``g_kept`` is ``g_new`` itself
    (no copy).
    """
    if y.device.type != "cuda":
        return fused_tracking_sweep_plain(y, g_new, g_old, params, mask)
    _check("fused_tracking_sweep", (y, g_new, g_old), params, mask)
    gated = mask is not None
    yo = torch.empty_like(y)
    gk = torch.empty_like(g_new) if gated else g_new
    S, C = y.shape[:2]
    d = _leaf_size(y)
    if yo.numel() == 0:
        return yo, gk
    outs = (yo, gk) if gated else (yo,)
    lib = _lib()
    with torch.cuda.device(y.device):
        err = lib.prox_sweep_tracking(
            y.data_ptr(), g_new.data_ptr(), g_old.data_ptr(),
            params.data_ptr(), mask.data_ptr() if gated else None,
            yo.data_ptr(), gk.data_ptr() if gated else None, S, C, d,
            _DTYPES[y.dtype], _vec_ok(d, y, g_new, g_old, *outs),
            _stream_ptr(y.device))
    if err != 0:
        raise RuntimeError(
            f"prox_sweep_tracking launch failed: CUDA error {err}")
    LAUNCH_COUNTS["tracking_sweep"] += 1
    return yo, gk


# ---------------------------------------------------------------------------
# One-config kernels: standalone prox and fused update
# ---------------------------------------------------------------------------

def hyper_row(like: torch.Tensor, lam, theta, alpha, gamma=0.0) -> torch.Tensor:
    """(1, 5) float32 row [lam, theta, alpha, gamma, 0] on ``like``'s device.

    Python numbers go over in one copy from pinned memory that does not
    block the host; 0-d tensors are stacked on the device (never read back
    to the host).
    """
    vals = (lam, theta, alpha, gamma, 0.0)
    if not any(isinstance(v, torch.Tensor) for v in vals):
        row = torch.tensor([vals], dtype=torch.float32)
        if like.device.type == "cuda":
            return row.pin_memory().to(like.device, non_blocking=True)
        return row.to(like.device)
    return torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                        device=like.device).reshape(())
                        for v in vals])[None]


def _check_leaf(name, operands):
    a = operands[0]
    for o in operands:
        if o.shape != a.shape or o.dtype != a.dtype or o.device != a.device:
            raise ValueError(f"{name}: operands differ in shape, dtype or "
                             "device")
    if a.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {a.dtype} not in "
                        f"{sorted(map(str, _DTYPES))}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {a.device}")


def _check_kind(kind):
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {sorted(KINDS)}, got {kind!r}")


def prox_plain(x, *, kind="l1", lam=1e-4, theta=4.0, alpha=0.1):
    """Plain PyTorch version of :func:`prox_cuda`: ``ref.py``'s prox in
    float32 on the table row's values, cast back once."""
    _check_leaf("prox", (x,))
    _check_kind(kind)
    row = hyper_row(x, lam, theta, alpha)[0]
    out = prox_ref(x.to(torch.float32), kind, row[0], row[1], row[2])
    return out.to(x.dtype)


def prox_cuda(x, *, kind="l1", lam=1e-4, theta=4.0, alpha=0.1):
    """prox_{alpha h}(x) for h in l1 | mcp | scad, any shape, fp32 or bf16.

    CUDA tensors launch the kernel, CPU tensors run :func:`prox_plain`.
    """
    if x.device.type != "cuda":
        return prox_plain(x, kind=kind, lam=lam, theta=theta, alpha=alpha)
    _check_leaf("prox", (x,))
    _check_kind(kind)
    xc = x.contiguous()
    out = torch.empty_like(xc)
    n = xc.numel()
    if n == 0:
        return out
    row = hyper_row(xc, lam, theta, alpha)
    lib = _lib()
    with torch.cuda.device(xc.device):
        err = lib.prox_apply(xc.data_ptr(), row.data_ptr(), out.data_ptr(),
                             n, KINDS[kind], _DTYPES[xc.dtype],
                             _vec_ok(n, xc, out), _stream_ptr(xc.device))
    if err != 0:
        raise RuntimeError(f"prox_apply launch failed: CUDA error {err}")
    LAUNCH_COUNTS["prox"] += 1
    return out


def fused_update_plain(x, y, nu, *, kind="l1", lam=1e-4, theta=4.0,
                       alpha=0.1, gamma=0.8):
    """Plain PyTorch version of :func:`fused_update_cuda`.  Returns
    (x', nu')."""
    _check_leaf("fused_update", (x, y, nu))
    _check_kind(kind)
    row = hyper_row(x, lam, theta, alpha, gamma)[0]
    f = lambda t: t.to(torch.float32)
    x_next, nu_next = fused_update_ref(f(x), f(y), f(nu), row[0], row[2],
                                       row[3], prox_kind=kind, theta=row[1])
    return x_next.to(x.dtype), nu_next.to(nu.dtype)


def fused_update_cuda(x, y, nu, *, kind="l1", lam=1e-4, theta=4.0,
                      alpha=0.1, gamma=0.8):
    """Fused momentum + prox of one config, any shape.  Returns (x', nu').

    CUDA tensors launch the sweep update kernel, ungated, on a (1, 1, n)
    view with a (1, 5) table; CPU tensors run :func:`fused_update_plain`.
    """
    if x.device.type != "cuda":
        return fused_update_plain(x, y, nu, kind=kind, lam=lam, theta=theta,
                                  alpha=alpha, gamma=gamma)
    _check_leaf("fused_update", (x, y, nu))
    _check_kind(kind)
    xc, yc, nc = (t.contiguous() for t in (x, y, nu))
    xo, nuo = torch.empty_like(xc), torch.empty_like(nc)
    n = xc.numel()
    if n == 0:
        return xo, nuo
    row = hyper_row(xc, lam, theta, alpha, gamma)
    lib = _lib()
    with torch.cuda.device(xc.device):
        err = lib.prox_sweep_update(
            xc.data_ptr(), yc.data_ptr(), nc.data_ptr(), row.data_ptr(), None,
            xo.data_ptr(), nuo.data_ptr(), 1, 1, n, KINDS[kind],
            _DTYPES[xc.dtype], _vec_ok(n, xc, yc, nc, xo, nuo),
            _stream_ptr(xc.device))
    if err != 0:
        raise RuntimeError(f"prox_sweep_update launch failed: CUDA error "
                           f"{err}")
    LAUNCH_COUNTS["fused_update"] += 1
    return xo, nuo
