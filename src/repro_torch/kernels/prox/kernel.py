"""DEPOSITUM prox and update kernels: CUDA for Hopper, plain PyTorch beside.

Port of ``repro/kernels/prox/kernel.py``.  The sweep-major pair, each one
grouped launch over every leaf of a tree:

* :func:`fused_update_sweep_grouped` replaces ``fused_update_sweep_pallas``
  (``_fused_sweep_kernel``), which the reference calls once a leaf:
  ``nu' = gamma nu + (1 - gamma) y`` and ``x' = prox_{alpha h}(x - alpha
  nu')`` for h in l1 | mcp | scad;
* :func:`fused_tracking_sweep_grouped` replaces
  ``fused_tracking_sweep_pallas`` (``_tracking_sweep_kernel``): ``y' = y +
  beta (g_new - g_old)``, and when gated ``g_kept = where(live, g_new,
  g_old)``;
* :func:`fused_update_sweep_cuda` / :func:`fused_tracking_sweep_cuda` are
  the same launches over a tree of one leaf.

and the one-config pair, each one grouped launch over every leaf of a
tree of any shapes (one row a leaf):

* :func:`prox_grouped` replaces ``prox_pallas`` (``_prox_kernel``), which
  the reference calls once a leaf: the standalone elementwise prox;
* :func:`fused_update_grouped` replaces ``fused_update_pallas``
  (``_fused_kernel``): the fused momentum + prox update of one config,
  which is the sweep update kernel's ungated instantiation;
* :func:`prox_cuda` / :func:`fused_update_cuda` are the same launches over
  a tree of one leaf.  All four take ``lam, theta, alpha[, gamma]`` as
  Python floats or 0-d tensors; they travel to the kernel as one (1, 5)
  table row a call on the operands' device, so a new value never rebuilds
  and a device tensor is never read back.

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

A grouped call on the card checks the whole tree in one pass, allocates one
buffer per output variable (leaf-major, each leaf at a 16-byte boundary)
and returns contiguous views of it in the inputs' shapes; it packs the leaf
table (:func:`leaf_tables`, a pure function of shapes, dtypes and
pointers) into a reused host buffer and makes one ``ctypes`` call per
launch (one per dtype and per ``MAX_LEAVES`` leaves).  It reads nothing
back from the device, so a CUDA graph can capture it.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import struct
import threading
from pathlib import Path
from typing import NamedTuple

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
#: the sweep kernels' launches of their gated instantiation (a cohort
#: mask), keyed as LAUNCH_COUNTS and counted there too
GATED_LAUNCH_COUNTS: collections.Counter = collections.Counter()

SOURCE = Path(__file__).parent / "csrc" / "prox_sweep.cu"
BUILD_DIR = Path(__file__).parent / "build"
# -fmad=false: one rounding per operation, as in the plain version;
# -Xptxas -v: each kernel's registers and spills in the build's log
NVCC_FLAGS = _build.BASE_FLAGS + ("-fmad=false", "-Xptxas", "-v")

# The grouped launch's leaf table, as prox_sweep.cu reads it.  Per storage
# type: the elements of one (s, c) row a block takes (Walk<T>::kTile, which
# the library reports and _lib checks) and those of one 16-byte vector
TILES = {torch.float32: 1024, torch.bfloat16: 4096}
VEC = {torch.float32: 4, torch.bfloat16: 8}
MAX_LEAVES = 48    # leaves in one launch's table (kMaxLeaves)
LEAF_WORDS = 8     # int64 words a leaf: 5 pointers, d, first block, vec
ALIGN = 16         # bytes: each leaf's place in an output buffer, a vector
_MAX_BLOCKS = 2**31 - 1

# Leaves that take each route of the sweep kernels, for the checks on the
# card: (elements a row, dtype, storage offset in elements).  bf16 takes
# 16-byte vectors at d 8, 2048 and 2^20 and goes element by element at the
# ragged d 1, 7, 9, 2047, 2^20 + 3 and on views 1 and 4 elements into
# their allocation (2 and 8 bytes: misaligned); fp32 leaves beside them (a
# mixed tree: one launch a dtype a call).  The gates of one config's two
# clients: none, all live, all frozen, the async learner's [1, 0] and a
# fraction.
ROUTE_LEAVES = ((1, torch.bfloat16, 0), (7, torch.bfloat16, 0),
                (8, torch.bfloat16, 0), (9, torch.bfloat16, 0),
                (2047, torch.bfloat16, 0), (2048, torch.bfloat16, 0),
                ((1 << 20) + 3, torch.bfloat16, 0),
                (1 << 20, torch.bfloat16, 0), (4096, torch.bfloat16, 1),
                (4096, torch.bfloat16, 4), (1001, torch.float32, 0),
                (1024, torch.float32, 0), (1024, torch.float32, 1))
ROUTE_GATES = {"ungated": None, "all live": [1.0, 1.0],
               "all frozen": [0.0, 0.0], "[1, 0]": [1.0, 0.0],
               "[0.5, 0]": [0.5, 0.0]}


def sweep_trees(update: bool, live_share: float | None = None) -> float:
    """Trees of storage one grouped sweep call moves, each input read once
    and each output written once: the update reads x, y, nu and writes x',
    nu' (5), tracking reads y, g_new, g_old and writes y' (4).  Gated, with
    ``live_share`` the share of live (s, c) rows: a live row moves 5 in
    both (tracking also writes g_kept), a frozen row 4 (two trees read and
    copied through), so 4.5 at the gate [1, 0]."""
    if live_share is None:
        return 5.0 if update else 4.0
    return 4.0 + live_share


def reset_launch_counts() -> None:
    LAUNCH_COUNTS.clear()
    GATED_LAUNCH_COUNTS.clear()


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
    """The built library with its entry points declared; raises unless
    it walks the tiles of :data:`TILES`."""
    path = build_library()
    lib = ctypes.CDLL(str(path))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.prox_sweep_tile.argtypes = [i]
    lib.prox_sweep_tile.restype = i
    built = {dt: lib.prox_sweep_tile(code) for dt, code in _DTYPES.items()}
    if built != TILES:
        raise RuntimeError(f"{path} walks tiles of {built}, the host "
                           f"{TILES}")
    lib.prox_sweep_update_grouped.argtypes = [p, i, p, p, i, ll, i, i, p]
    lib.prox_sweep_update_grouped.restype = i
    lib.prox_sweep_tracking_grouped.argtypes = [p, i, p, p, i, ll, i, p]
    lib.prox_sweep_tracking_grouped.restype = i
    lib.prox_apply_grouped.argtypes = [p, i, p, i, i, p]
    lib.prox_apply_grouped.restype = i
    return lib


# ---------------------------------------------------------------------------
# Checks shared by the kernel and its plain version
# ---------------------------------------------------------------------------

def _check_aux(name, params, mask, S, C, device):
    for label, t, shape in (("params", params, (S, 5)),
                            ("mask", mask, (S, C))):
        if t is None:
            continue
        if (t.shape != shape or t.dtype != torch.float32
                or t.device != device or not t.is_contiguous()):
            raise ValueError(
                f"{name}: {label} must be a contiguous float32 {shape} "
                f"tensor on {device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {device}")


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
    _check_aux(name, params, mask, S, C, a.device)


def _check_group(name, leaves, params, mask, lead):
    """:func:`_check` over a whole tree in one pass.

    ``leaves`` holds each leaf's operands (three, or the prox's one).
    Every leaf's operands agree in shape and dtype and are contiguous, all
    leaves lie on one device and share their first ``lead`` axes: ``(S,
    C)`` for lead 2, ``(C,)`` of one config (S = 1) for lead 1, one row for
    lead 0.  Returns (S, C, elements a row of each leaf, each leaf's dtype).
    """
    a0 = leaves[0][0]
    if a0.ndim < lead:
        raise ValueError(f"{name}: operands must be (S, C, ...), got "
                         f"{tuple(a0.shape)}")
    head, device = a0.shape[:lead], a0.device
    rows = 1
    for n in head:
        rows *= n
    ds, dts = [], []
    for ops in leaves:
        a = ops[0]
        shape, dtype = a.shape, a.dtype
        if any(o.shape != shape or o.dtype != dtype or o.device != device
               for o in ops):
            raise ValueError(f"{name}: operands differ in shape, dtype or "
                             "device")
        if not all(o.is_contiguous() for o in ops):
            raise ValueError(f"{name}: operands must be contiguous")
        if dtype not in _DTYPES:
            raise TypeError(f"{name}: dtype {dtype} not in "
                            f"{sorted(map(str, _DTYPES))}")
        if shape[:lead] != head:
            raise ValueError(f"{name}: leaves differ in their leading "
                             f"axes: {tuple(shape)} against {tuple(head)}")
        ds.append(a.numel() // rows if rows else 0)
        dts.append(dtype)
    S, C = ((head[0], head[1]) if lead == 2
            else (1, head[0]) if lead == 1 else (1, 1))
    _check_aux(name, params, mask, S, C, device)
    return S, C, ds, dts


def _check_kind(kind):
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {sorted(KINDS)}, got {kind!r}")


def _col(params: torch.Tensor, j: int, ndim: int) -> torch.Tensor:
    """Column j of the table as (S, 1, ...) for broadcasting."""
    return params[:, j].reshape((-1,) + (1,) * (ndim - 1))


def _live(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return (mask > 0).reshape(mask.shape + (1,) * (ndim - 2))


def _stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# The grouped launch: leaf table, output layout, one call per launch
# ---------------------------------------------------------------------------

class Launch(NamedTuple):
    """One grouped launch: entries ``[start, stop)`` of the leaf table."""
    dtype: torch.dtype
    start: int
    stop: int
    blocks: int


def output_layout(nbytes) -> tuple[list[int], int]:
    """Byte offsets of leaves of ``nbytes`` bytes laid out leaf-major in one
    buffer, each rounded up to ``ALIGN``, and the buffer's size."""
    offsets, total = [], 0
    for n in nbytes:
        offsets.append(total)
        total += -(-n // ALIGN) * ALIGN
    return offsets, total


def leaf_tables(rows: int, ds, dtypes, ptrs):
    """The leaf tables of one grouped call, from shapes, dtypes and pointers.

    ``rows`` is S * C, ``ds[i]`` leaf i's elements a row, ``dtypes[i]`` its
    dtype and ``ptrs[i]`` its five pointers as ints (three operands, two
    outputs; 0 for an output the kernel does not write).  Leaves without an
    element are skipped; the rest are grouped by dtype, in order of first
    appearance, and cut into launches of at most ``MAX_LEAVES``.  A leaf's
    entry holds its pointers, d, its first block in its launch (a row takes
    ceil(d / tile) blocks, the dtype's tile in :data:`TILES`) and its vec
    flag (16-byte loads: d a multiple of the dtype's :data:`VEC`, all five
    pointers 16-byte aligned).  Returns ``(words, launches)``: the entries
    as one flat list of ints, ``LEAF_WORDS`` a leaf, and one
    :class:`Launch` per launch over entries ``[start, stop)``.
    """
    groups: dict = {}
    for i, (d, dt) in enumerate(zip(ds, dtypes)):
        if d and rows:
            groups.setdefault(dt, []).append(i)
    words, launches, n = [], [], 0
    for dt, idx in groups.items():
        tile, vec = TILES[dt], VEC[dt]
        for k in range(0, len(idx), MAX_LEAVES):
            chunk, start, first = idx[k:k + MAX_LEAVES], n, 0
            for i in chunk:
                p, d = ptrs[i], ds[i]
                aligned = (p[0] | p[1] | p[2] | p[3] | p[4]) % ALIGN == 0
                words += p
                words += (d, first, int(d % vec == 0 and aligned))
                first += rows * -(-d // tile)
            if first > _MAX_BLOCKS:
                raise ValueError(f"grouped launch of {first} blocks exceeds "
                                 f"the grid's {_MAX_BLOCKS}")
            n += len(chunk)
            launches.append(Launch(dt, start, n, first))
    return words, launches


_HOST = threading.local()   # each thread's reused leaf-table buffer


@functools.lru_cache(maxsize=None)
def _int64s(n: int):
    return struct.Struct(f"{n}q").pack_into


def _packed(words) -> int:
    """``words`` as int64 in this thread's reused ``ctypes`` buffer (grown
    when too small); returns the buffer's address.  The kernel takes its
    table by value, so the buffer is free again once the call returns."""
    buf = getattr(_HOST, "table", None)
    if buf is None or len(buf) < len(words):
        buf = (ctypes.c_int64 * max(len(words), MAX_LEAVES * LEAF_WORDS))()
        _HOST.table, _HOST.addr = buf, ctypes.addressof(buf)
    _int64s(len(words))(buf, 0, *words)
    return _HOST.addr


def _buffer(nbytes, dtypes, device):
    """One allocation of ``nbytes`` viewed as each of ``dtypes`` (typed
    directly when there is one), and its address."""
    kinds = set(dtypes)
    if len(kinds) == 1:
        (dt,) = kinds
        buf = torch.empty(nbytes // dt.itemsize, dtype=dt, device=device)
        return {dt: buf}, buf.data_ptr()
    buf = torch.empty(nbytes, dtype=torch.uint8, device=device)
    return {dt: buf.view(dt) for dt in kinds}, buf.data_ptr()


def _launch_grouped(name, key, leaves, params, mask, lead, kind=None):
    """Check, allocate and launch one grouped call on the card.

    ``leaves`` holds each leaf's (a, b, c) operands, or for ``key`` "prox"
    its one operand x; ``kind`` None is the tracking axpy.  Returns the
    outputs' lists of leaves: the prox's one, the others' two; ungated
    tracking returns the ``b`` leaves (g_new) themselves as the second.
    """
    S, C, ds, dts = _check_group(name, leaves, params, mask, lead)
    prox, tracking, gated = key == "prox", kind is None, mask is not None
    if not tracking:
        _check_kind(kind)
    device, rows = leaves[0][0].device, S * C
    offsets, total = output_layout(
        [rows * d * dt.itemsize for d, dt in zip(ds, dts)])
    views, base0 = _buffer(total, dts, device)
    first = [views[dt].as_strided(a.shape, a.stride(), off // dt.itemsize)
             for (a, *_), off, dt in zip(leaves, offsets, dts)]
    if prox:                             # one output
        ptrs = [(a.data_ptr(), 0, 0, base0 + off, 0)
                for (a,), off in zip(leaves, offsets)]
    elif gated or not tracking:          # a second output to write
        views, base1 = _buffer(total, dts, device)
        second = [views[dt].as_strided(a.shape, a.stride(),
                                       off // dt.itemsize)
                  for (a, _, _), off, dt in zip(leaves, offsets, dts)]
        ptrs = [(a.data_ptr(), b.data_ptr(), c.data_ptr(), base0 + off,
                 base1 + off) for (a, b, c), off in zip(leaves, offsets)]
    else:
        second = [b for _, b, _ in leaves]      # g_kept is g_new itself
        ptrs = [(a.data_ptr(), b.data_ptr(), c.data_ptr(), base0 + off, 0)
                for (a, b, c), off in zip(leaves, offsets)]
    outs = (first,) if prox else (first, second)
    words, launches = leaf_tables(rows, ds, dts, ptrs)
    if not launches:
        return outs
    addr = _packed(words)
    lib = _lib()
    p_ptr, m_ptr = params.data_ptr(), mask.data_ptr() if gated else None
    if prox:       # the table fixes the grid; no mask, C or block count
        def fn(table, n, blocks, dtype, stream):
            return lib.prox_apply_grouped(table, n, p_ptr, KINDS[kind],
                                          dtype, stream)
    else:
        entry = (lib.prox_sweep_tracking_grouped if tracking
                 else lib.prox_sweep_update_grouped)
        extra = () if tracking else (KINDS[kind],)

        def fn(table, n, blocks, dtype, stream):
            return entry(table, n, p_ptr, m_ptr, C, blocks, *extra, dtype,
                         stream)
    with torch.cuda.device(device):
        stream = _stream_ptr(device)
        for ln in launches:
            err = fn(addr + ln.start * LEAF_WORDS * 8, ln.stop - ln.start,
                     ln.blocks, _DTYPES[ln.dtype], stream)
            if err != 0:
                raise RuntimeError(f"{name} grouped launch failed: CUDA "
                                   f"error {err}")
            LAUNCH_COUNTS[key] += 1
            if gated:
                GATED_LAUNCH_COUNTS[key] += 1
    return outs


def _plain_leaf(fn, ops, lead, *args, **kw):
    """A sweep plain version on one leaf whose first ``lead`` axes are its
    rows: (S, C, ...) as it is, (C, ...) and any shape as (1, ...) views."""
    if lead == 2:
        return fn(*ops, *args, **kw)
    pad = (1,) * (2 - lead)
    outs = fn(*(o.reshape(pad + tuple(o.shape)) for o in ops), *args, **kw)
    return tuple(o.reshape(ops[0].shape) for o in outs)


# ---------------------------------------------------------------------------
# Fused momentum + prox update
# ---------------------------------------------------------------------------

def fused_update_sweep_plain(x, y, nu, params, mask=None, *, kind="l1"):
    """Plain PyTorch version of :func:`fused_update_sweep_cuda`.

    Computes in float32 whatever the storage type, then casts back, as the
    kernel does.  Returns (x', nu').
    """
    _check("fused_update_sweep", (x, y, nu), params, mask)
    _check_kind(kind)
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


def fused_update_sweep_grouped_plain(xs, ys, nus, params, mask=None, *,
                                     kind="l1", lead=2):
    """Plain PyTorch version of :func:`fused_update_sweep_grouped`:
    :func:`fused_update_sweep_plain` leaf by leaf."""
    leaves = list(zip(xs, ys, nus))
    if not leaves:
        return [], []
    _check_group("fused_update_sweep", leaves, params, mask, lead)
    _check_kind(kind)
    outs = [_plain_leaf(fused_update_sweep_plain, ops, lead, params, mask,
                        kind=kind) for ops in leaves]
    return [o[0] for o in outs], [o[1] for o in outs]


def fused_update_sweep_grouped(xs, ys, nus, params, mask=None, *,
                               kind="l1", lead=2):
    """Sweep-major fused momentum + prox update of every leaf of a tree.

    ``xs``/``ys``/``nus``: sequences of contiguous leaves, fp32 or bf16,
    ``(S, C, *p)`` for ``lead`` 2, or ``(C, *p)`` leaves of one config for
    ``lead`` 1 (then ``params`` is (1, 5) and ``mask`` (1, C)); ``params``:
    the (S, 5) table; ``mask``: optional (S, C) gate.  On the card one
    launch per dtype (and per ``MAX_LEAVES`` leaves); x' and nu' are views
    of one allocation each.  CPU tensors run
    :func:`fused_update_sweep_grouped_plain`.  Returns (x' leaves, nu'
    leaves) as lists.
    """
    leaves = list(zip(xs, ys, nus))
    if not leaves or leaves[0][0].device.type != "cuda":
        return fused_update_sweep_grouped_plain(xs, ys, nus, params, mask,
                                                kind=kind, lead=lead)
    return _launch_grouped("fused_update_sweep", "fused_sweep", leaves,
                           params, mask, lead, kind)


def fused_update_sweep_cuda(x, y, nu, params, mask=None, *, kind="l1"):
    """Sweep-major fused momentum + prox update of one leaf: the grouped
    launch over a tree of one leaf.  Returns (x', nu').

    ``x``/``y``/``nu``: contiguous (S, C, *p) fp32 or bf16; ``params``: the
    (S, 5) table; ``mask``: optional (S, C) gate.  CUDA tensors launch the
    kernel, CPU tensors run :func:`fused_update_sweep_plain`.
    """
    if x.device.type != "cuda":
        return fused_update_sweep_plain(x, y, nu, params, mask, kind=kind)
    xs, nus = _launch_grouped("fused_update_sweep", "fused_sweep",
                              [(x, y, nu)], params, mask, 2, kind)
    return xs[0], nus[0]


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


def fused_tracking_sweep_grouped_plain(ys, g_news, g_olds, params,
                                       mask=None, *, lead=2):
    """Plain PyTorch version of :func:`fused_tracking_sweep_grouped`:
    :func:`fused_tracking_sweep_plain` leaf by leaf."""
    leaves = list(zip(ys, g_news, g_olds))
    if not leaves:
        return [], []
    _check_group("fused_tracking_sweep", leaves, params, mask, lead)
    outs = [_plain_leaf(fused_tracking_sweep_plain, ops, lead, params, mask)
            for ops in leaves]
    kept = ([o[1] for o in outs] if mask is not None
            else [ops[1] for ops in leaves])
    return [o[0] for o in outs], kept


def fused_tracking_sweep_grouped(ys, g_news, g_olds, params, mask=None, *,
                                 lead=2):
    """Sweep-major tracking axpy of every leaf of a tree.  Returns (y'
    leaves, g_kept leaves).

    Same layout contract as :func:`fused_update_sweep_grouped`; ``beta`` is
    column 4 of the table.  Without a mask the ``g_kept`` leaves are the
    ``g_news`` themselves (no copy).
    """
    leaves = list(zip(ys, g_news, g_olds))
    if not leaves or leaves[0][0].device.type != "cuda":
        return fused_tracking_sweep_grouped_plain(ys, g_news, g_olds, params,
                                                  mask, lead=lead)
    return _launch_grouped("fused_tracking_sweep", "tracking_sweep", leaves,
                           params, mask, lead)


def fused_tracking_sweep_cuda(y, g_new, g_old, params, mask=None):
    """Sweep-major tracking axpy of one leaf: the grouped launch over a
    tree of one leaf.  Returns (y', g_kept).

    Same layout contract as :func:`fused_update_sweep_cuda`; ``beta`` is
    column 4 of the table.  Without a mask ``g_kept`` is ``g_new`` itself
    (no copy).
    """
    if y.device.type != "cuda":
        return fused_tracking_sweep_plain(y, g_new, g_old, params, mask)
    ys, gs = _launch_grouped("fused_tracking_sweep", "tracking_sweep",
                             [(y, g_new, g_old)], params, mask, 2)
    return ys[0], gs[0]


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


def prox_grouped_plain(xs, *, kind="l1", lam=1e-4, theta=4.0, alpha=0.1):
    """Plain PyTorch version of :func:`prox_grouped`: ``ref.py``'s prox in
    float32 on the table row's values, cast back once, leaf by leaf."""
    xs = [x.contiguous() for x in xs]
    if not xs:
        return []
    row = hyper_row(xs[0], lam, theta, alpha)
    _check_group("prox", [(x,) for x in xs], row, None, 0)
    _check_kind(kind)
    r = row[0]
    return [prox_ref(x.to(torch.float32), kind, r[0], r[1], r[2]).to(x.dtype)
            for x in xs]


def prox_grouped(xs, *, kind="l1", lam=1e-4, theta=4.0, alpha=0.1):
    """prox_{alpha h} of every leaf of a tree, h in l1 | mcp | scad.

    ``xs``: leaves of any shapes, fp32 or bf16, on one device.  On the card
    one launch per dtype (and per ``MAX_LEAVES`` leaves) with one (1, 5)
    row for the call; the results are views of one allocation.  CPU
    tensors run :func:`prox_grouped_plain`.  Returns a list.
    """
    xs = [x.contiguous() for x in xs]
    if not xs or xs[0].device.type != "cuda":
        return prox_grouped_plain(xs, kind=kind, lam=lam, theta=theta,
                                  alpha=alpha)
    row = hyper_row(xs[0], lam, theta, alpha)
    (outs,) = _launch_grouped("prox", "prox", [(x,) for x in xs], row, None,
                              0, kind)
    return outs


def prox_plain(x, *, kind="l1", lam=1e-4, theta=4.0, alpha=0.1):
    """Plain PyTorch version of :func:`prox_cuda`."""
    return prox_grouped_plain([x], kind=kind, lam=lam, theta=theta,
                              alpha=alpha)[0]


def prox_cuda(x, *, kind="l1", lam=1e-4, theta=4.0, alpha=0.1):
    """prox_{alpha h}(x) for h in l1 | mcp | scad, any shape, fp32 or bf16:
    the grouped launch over a tree of one leaf.

    CUDA tensors launch the kernel, CPU tensors run :func:`prox_plain`.
    """
    return prox_grouped([x], kind=kind, lam=lam, theta=theta,
                        alpha=alpha)[0]


def fused_update_grouped_plain(xs, ys, nus, *, kind="l1", lam=1e-4,
                               theta=4.0, alpha=0.1, gamma=0.8):
    """Plain PyTorch version of :func:`fused_update_grouped`.  Returns (x'
    leaves, nu' leaves)."""
    leaves = [tuple(t.contiguous() for t in ops)
              for ops in zip(xs, ys, nus)]
    if not leaves:
        return [], []
    row = hyper_row(leaves[0][0], lam, theta, alpha, gamma)
    _check_group("fused_update", leaves, row, None, 0)
    _check_kind(kind)
    r = row[0]
    f = lambda t: t.to(torch.float32)
    outs = [fused_update_ref(f(x), f(y), f(nu), r[0], r[2], r[3],
                             prox_kind=kind, theta=r[1])
            for x, y, nu in leaves]
    return ([o[0].to(x.dtype) for o, (x, _, _) in zip(outs, leaves)],
            [o[1].to(nu.dtype) for o, (_, _, nu) in zip(outs, leaves)])


def fused_update_grouped(xs, ys, nus, *, kind="l1", lam=1e-4, theta=4.0,
                         alpha=0.1, gamma=0.8):
    """Fused momentum + prox of one config over every leaf of a tree.

    Leaves of any shapes, fp32 or bf16, on one device; each leaf's x, y
    and nu agree in shape and dtype.  On the card the sweep update kernel
    runs ungated, one row a leaf, one launch per dtype (and per
    ``MAX_LEAVES`` leaves) with one (1, 5) row; CPU tensors run
    :func:`fused_update_grouped_plain`.  Returns (x' leaves, nu' leaves).
    """
    leaves = [tuple(t.contiguous() for t in ops)
              for ops in zip(xs, ys, nus)]
    if not leaves or leaves[0][0].device.type != "cuda":
        return fused_update_grouped_plain(xs, ys, nus, kind=kind, lam=lam,
                                          theta=theta, alpha=alpha,
                                          gamma=gamma)
    row = hyper_row(leaves[0][0], lam, theta, alpha, gamma)
    return _launch_grouped("fused_update", "fused_update", leaves, row, None,
                           0, kind)


def fused_update_plain(x, y, nu, *, kind="l1", lam=1e-4, theta=4.0,
                       alpha=0.1, gamma=0.8):
    """Plain PyTorch version of :func:`fused_update_cuda`.  Returns
    (x', nu')."""
    xs, nus = fused_update_grouped_plain([x], [y], [nu], kind=kind, lam=lam,
                                         theta=theta, alpha=alpha,
                                         gamma=gamma)
    return xs[0], nus[0]


def fused_update_cuda(x, y, nu, *, kind="l1", lam=1e-4, theta=4.0,
                      alpha=0.1, gamma=0.8):
    """Fused momentum + prox of one config, any shape: the grouped launch
    over a tree of one leaf.  Returns (x', nu').

    CUDA tensors launch the kernel, CPU tensors run
    :func:`fused_update_plain`.
    """
    xs, nus = fused_update_grouped([x], [y], [nu], kind=kind, lam=lam,
                                   theta=theta, alpha=alpha, gamma=gamma)
    return xs[0], nus[0]
