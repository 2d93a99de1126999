"""The card's hardware model, device meshes over ``torch.distributed``, and
the shard axis the per-shard mixing bodies run on (port of
``repro/launch/mesh.py``).

``HW`` describes one NVIDIA H100 SXM under the reference's keys, so that
:func:`repro_torch.analysis.roofline.roofline_terms` reads it as the
reference reads its TPU v5e entry, plus ``peak_flops_fp32`` for the fp32
kernels' bounds (``chip_smoke.py`` reads all four).  The rates are
NVIDIA's H100 SXM datasheet's, dense, at the full 700 W power limit.

PyTorch runs one process a device, so a :class:`Mesh` is an ordered
mapping from axis name to size over the ranks of the initialised process
group (rank = the row-major index of the process's coordinates).  A mesh
built without a live group is *abstract*: its shape alone, enough to
evaluate sharding rules and the dry run for the reference's 16 x 16 and
2 x 16 x 16 shapes without 256 devices.

:meth:`Mesh.axis` gives a :class:`ShardAxis`: one axis (or several,
combined row-major, like a tuple of mesh axes in the reference) over its
own process group.  It offers what ``shard_map`` bodies take from
``jax.lax``: ``axis_index``, ``ppermute`` (one ``batch_isend_irecv``
round), ``all_gather`` (tiled), ``psum`` and ``pmean``; and what the
callers of a sharded client axis need: ``rows`` / ``take`` (this process's
block of global per-client tensors) and ``client_sum`` / ``client_mean``
(over every process's rows).  A gloo group takes CPU tensors and an NCCL
group CUDA tensors; any other pairing raises, so no collective is staged
through the host behind the caller's back.  :data:`LOCAL_AXIS`, the axis
of a process that holds every client, makes every collective the
identity, so stacked and sharded callers share one code path.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist

# NVIDIA H100 SXM, per card
HW = {
    "peak_flops_bf16": 989e12,   # FLOP/s, tensor cores, dense
    "hbm_bandwidth": 3.35e12,    # B/s, HBM3
    # B/s, one NVLink 4 link one way (conservative single link): 18 links
    # carry the datasheet's 900 GB/s, 450 GB/s each way
    "ici_bandwidth": 25e9,
    "peak_flops_fp32": 67e12,    # FLOP/s, outside the tensor cores
}

#: the reference's production mesh shapes (one pod; two pods)
PRODUCTION_SHAPES = {
    False: (("data", 16), ("model", 16)),
    True: (("pod", 2), ("data", 16), ("model", 16)),
}


# torch >= 2.13 renames all_gather_into_tensor (same arguments)
_all_gather_single = getattr(dist, "all_gather_single", None) or getattr(
    dist, "all_gather_into_tensor", None)


def _live() -> bool:
    return dist.is_available() and dist.is_initialized()


class ShardAxis:
    """One (possibly combined) mesh axis as this process sees it.

    ``index`` is the process's position along the axis, ``ranks`` the
    global ranks of the axis's members in axis order, ``group`` their
    process group (None on a one-process axis without a live group: every
    collective is then the identity, as ``jax.lax``'s are at size 1).
    """

    def __init__(self, name, size: int, index: int,
                 group: Optional[dist.ProcessGroup] = None,
                 ranks: Sequence[int] = (0,)):
        self.name = name
        self.size = int(size)
        self.index = int(index)
        self.group = group
        self.ranks = tuple(ranks)
        if self.group is None and self.size > 1:
            raise ValueError(f"axis {name!r} of size {size} needs a live "
                             "process group")

    def __repr__(self) -> str:
        return (f"ShardAxis({self.name!r}, size={self.size}, "
                f"index={self.index})")

    def axis_index(self) -> int:
        return self.index

    def rows(self, n: int) -> slice:
        """This process's contiguous block of ``n`` rows sharded over the
        axis (``n`` a multiple of the size)."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split over {self.size} "
                             f"shards of axis {self.name!r}")
        blk = n // self.size
        return slice(self.index * blk, (self.index + 1) * blk)

    def take(self, tree, dim: int = 0):
        """This process's rows of global per-client tensors, the client
        axis at ``dim``: a tensor, or a dict / tuple / list of them (None
        passes); the tree itself on a one-shard axis."""
        if self.size == 1 or tree is None:
            return tree
        if isinstance(tree, dict):
            return {k: self.take(v, dim) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(self.take(v, dim) for v in tree)
        r = self.rows(tree.shape[dim])
        return tree.narrow(dim, r.start, r.stop - r.start)

    def client_sum(self, v: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The fp32 sum over client dim ``dim`` of every shard's rows."""
        return self.psum(torch.sum(v.to(torch.float32), dim=dim))

    def client_mean(self, v: torch.Tensor, dim: int = 0,
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The mean over client dim ``dim`` (0, or 1 on a sweep's
        ``(S, blk, ...)`` leaves) of every shard's rows, accumulated in
        fp32 and returned in ``v``'s dtype.  ``weights`` (global: ``(n,)``,
        or ``(S, n)`` at dim 1) restrict it to a sub-population (padding
        rows out of the average); without them the divisor is every
        shard's rows, padding included."""
        if weights is None:
            return (self.client_sum(v, dim)
                    / (v.shape[dim] * self.size)).to(v.dtype)
        w32 = weights.to(torch.float32)
        w = self.take(w32, -1) / torch.clamp_min(
            torch.sum(w32, dim=-1, keepdim=True), 1e-12)
        v32 = v.to(torch.float32)
        if dim == 0:
            out = torch.einsum("i,i...->...", w, v32)
        else:
            out = torch.einsum("si,si...->s...", w.expand(v.shape[:2]), v32)
        return self.psum(out).to(v.dtype)

    def _check(self, x: torch.Tensor) -> None:
        """The group's backend must take ``x``'s device as it is."""
        backend = dist.get_backend(self.group)
        if backend == "gloo" and x.device.type == "cpu":
            return
        if backend == "nccl" and x.device.type == "cuda":
            return
        raise ValueError(
            f"a {backend} group does not take {x.device.type} tensors here "
            "(gloo: CPU, nccl: CUDA); no collective is staged through the "
            "host")

    def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        """``lax.ppermute``: for every ``(src, dst)`` pair, position
        ``src`` sends its ``x`` to ``dst``; a position no pair targets gets
        zeros.  One ``batch_isend_irecv`` round; the identity at size 1."""
        out = None
        ops = []
        for src, dst in perm:
            if src == self.index and dst == self.index:
                out = x
            elif src == self.index:
                ops.append(("send", dst))
            elif dst == self.index:
                out = torch.empty_like(x)
                ops.append(("recv", src))
        if ops:
            self._check(x)
            send = x.contiguous()
            p2p = [dist.P2POp(dist.isend if kind == "send" else dist.irecv,
                              send if kind == "send" else out,
                              self.ranks[peer], self.group)
                   for kind, peer in ops]
            for req in dist.batch_isend_irecv(p2p):
                req.wait()
        return torch.zeros_like(x) if out is None else out

    def all_gather(self, x: torch.Tensor, tiled: bool = True
                   ) -> torch.Tensor:
        """Every position's ``x`` in axis order: concatenated on dim 0
        (``tiled``) or stacked on a new dim 0."""
        if self.group is None:
            return x if tiled else x[None]
        self._check(x)
        x = x.contiguous()
        out = torch.empty((self.size * x.shape[0],) + tuple(x.shape[1:])
                          if tiled else (self.size,) + tuple(x.shape),
                          dtype=x.dtype, device=x.device)
        _all_gather_single(out, x, group=self.group)
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the axis (a new tensor)."""
        if self.group is None:
            return x
        self._check(x)
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the axis."""
        if self.group is None:
            return x
        return self.psum(x) / self.size


#: The client axis of a process that holds every client: its collectives
#: are the identity, so one code path serves sharded and stacked callers.
LOCAL_AXIS = ShardAxis("local", 1, 0)


def client_axis(backend) -> ShardAxis:
    """A backend's sharded client axis (``backend.axis``), else
    :data:`LOCAL_AXIS`."""
    return getattr(backend, "axis", LOCAL_AXIS)


@dataclasses.dataclass(eq=False)
class Mesh:
    """An ordered mapping from axis name to size, over the live process
    group or abstract.

    ``coords`` is this process's coordinate on every axis (None on an
    abstract mesh, and for a process outside a live mesh smaller than the
    world); ``shape`` the reference's ``mesh.shape`` dict.
    """

    axis_names: tuple
    axis_sizes: tuple
    coords: Optional[tuple] = None
    live: bool = False
    _axes: dict = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def abstract(cls, shape) -> "Mesh":
        """A mesh of this shape (a dict or ``(name, size)`` pairs) with no
        process behind it: for sharding rules and the dry run."""
        pairs = tuple(shape.items()) if isinstance(shape, dict) else tuple(
            shape)
        return cls(tuple(n for n, _ in pairs), tuple(int(s) for _, s in pairs))

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def _rank_of(self, coords) -> int:
        r = 0
        for c, s in zip(coords, self.axis_sizes):
            r = r * s + c
        return r

    def axis(self, names) -> ShardAxis:
        """The :class:`ShardAxis` over mesh axis ``names`` (a name, or a
        tuple combined row-major) through this process.

        On a live mesh every process must ask for the same axes in the
        same order (the first call builds the groups, one a coordinate of
        the other axes, collectively)."""
        key = tuple(names) if isinstance(names, (tuple, list)) else (names,)
        if key in self._axes:
            return self._axes[key]
        for a in key:
            if a not in self.axis_names:
                raise KeyError(f"no axis {a!r} in mesh {self.shape}")
        pos = [self.axis_names.index(a) for a in key]
        size = math.prod(self.axis_sizes[p] for p in pos)
        name = key if len(key) > 1 else key[0]
        if not self.live:
            if size > 1:
                raise ValueError(
                    f"mesh {self.shape} has no process group: axis "
                    f"{name!r} of size {size} has no processes behind it")
            self._axes[key] = ShardAxis(name, 1, 0)
            return self._axes[key]
        others = [i for i in range(len(self.axis_names)) if i not in pos]
        mine = None
        for fixed in itertools.product(
                *(range(self.axis_sizes[i]) for i in others)):
            ranks = []
            for along in itertools.product(
                    *(range(self.axis_sizes[p]) for p in pos)):
                c = [0] * len(self.axis_names)
                for i, v in zip(others, fixed):
                    c[i] = v
                for p, v in zip(pos, along):
                    c[p] = v
                ranks.append(self._rank_of(c))
            if len(ranks) == dist.get_world_size():
                group = dist.group.WORLD
            else:
                group = dist.new_group(ranks)
            if self.coords is not None and all(
                    self.coords[i] == v for i, v in zip(others, fixed)):
                index = 0
                for p in pos:
                    index = index * self.axis_sizes[p] + self.coords[p]
                mine = ShardAxis(name, size, index, group, ranks)
        if mine is None:
            raise ValueError(f"this process (rank {dist.get_rank()}) is "
                             f"outside mesh {self.shape}")
        self._axes[key] = mine
        return mine


def _live_mesh(pairs) -> Mesh:
    names = tuple(n for n, _ in pairs)
    sizes = tuple(int(s) for _, s in pairs)
    rank = dist.get_rank()
    coords = None
    if rank < math.prod(sizes):
        coords, r = [], rank
        for s in reversed(sizes):
            coords.append(r % s)
            r //= s
        coords = tuple(reversed(coords))
    return Mesh(names, sizes, coords, live=True)


def parse_mesh(text: str, multi_pod: bool = False) -> tuple:
    """``"DxM"`` (or ``"PxDxM"``) -> ``(name, size)`` pairs on the
    reference's axis names."""
    sizes = tuple(int(v) for v in text.lower().split("x"))
    names = ("pod", "data", "model") if len(sizes) == 3 else (
        ("data", "model") if len(sizes) == 2 else None)
    if names is None:
        raise ValueError(f"mesh {text!r}: expected DxM or PxDxM")
    if multi_pod and "pod" not in names:
        names, sizes = ("pod", "data", "model"), (2,) + sizes
    return tuple(zip(names, sizes))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh: (data=16, model=16), or (pod=2,
    data=16, model=16).  Over the live process group when one is
    initialised (its world size must match, else ``ValueError``); without
    one, the abstract mesh the dry run evaluates its rules on."""
    pairs = PRODUCTION_SHAPES[bool(multi_pod)]
    if not _live():
        return Mesh.abstract(pairs)
    n = math.prod(s for _, s in pairs)
    if dist.get_world_size() != n:
        raise ValueError(f"production mesh needs {n} processes, the group "
                         f"has {dist.get_world_size()}")
    return _live_mesh(pairs)


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A (data, model) mesh over the processes that exist: the live
    group's world size, or this one process.  Raises ``ValueError`` when
    ``data * model`` exceeds it, as the reference does for devices."""
    n = dist.get_world_size() if _live() else 1
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} > {n} devices")
    pairs = (("data", data), ("model", model))
    if not _live():
        return Mesh(("data", "model"), (data, model), (0, 0))
    return _live_mesh(pairs)


def make_client_mesh(axis_name: str = "clients") -> Mesh:
    """A one-axis mesh of every process of the live group (this process
    alone without one): the mesh :func:`~repro_torch.training.backends.
    suggest_backend` shards the client axis over."""
    if not _live():
        return Mesh((axis_name,), (1,), (0,))
    return _live_mesh(((axis_name, dist.get_world_size()),))
