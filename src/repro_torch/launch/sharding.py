"""Logical-axis sharding rules (port of ``repro/launch/sharding.py``): map
the zoo's logical parameter / activation axes onto mesh axes, greedily,
with a divisibility fallback (a dim that a mesh axis does not divide is
replicated — e.g. grok's 8 experts on a 16-way axis).

Two client-placement modes:

* ``replicated`` — clients on the data axes (16 single-pod, 32 multi-pod);
  each client tensor-parallel over ``model``.
* ``pod`` (pod-as-client) — each pod is one FL client; client tensors are
  FSDP + TP sharded over ``("data", "model")`` inside the pod (grok-1-314b,
  qwen3-moe-235b-a22b).

The mesh is a :class:`~repro_torch.launch.mesh.Mesh`: live over a process
group, or abstract (the reference's 16 x 16 and 2 x 16 x 16 shapes without
256 devices).  A spec is a tuple with one entry a dim — a mesh axis name,
a tuple of names, or None (replicated) — trimmed of trailing Nones as the
reference trims its ``PartitionSpec``.  The port's processes shard the
client dim only (:mod:`repro_torch.launch.gossip_dist` reads the client
entry); the model-axis entries are the reference's placement, which the
dry run prices (:func:`shard_shape`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

PyTree = Any


def is_axes_leaf(x) -> bool:
    """An axes tuple like ('embed', 'mlp') / (None,) / () is a leaf."""
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        a is None or isinstance(a, str) for a in x)


POD_AS_CLIENT_ARCHS = {"grok-1-314b", "qwen3-moe-235b-a22b"}

# ordered mesh-axis preferences per logical axis, per mode
_RULES_REPLICATED = {
    "clients": ("__clients__",),       # expanded to placement.clients_axes
    "qkv": ("model",),
    "heads": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    "vocab": ("model",),
    "ssm_inner": ("model",),
    "embed": (),                       # replicated
    "batch": (),                       # per-client batch replicated
    "dbatch": ("data",),               # serving batch over data axes
    "seq": (),
    "layers": (), "groups": (),
    "cache": ("model",), "kv": (), "hd": (),
    "ssm_state": ("model",),
    "memseq": ("model",),
}

_RULES_POD_CLIENT = {
    "clients": ("__clients__",),
    "qkv": ("model",),
    "heads": ("model",),
    "mlp": ("model",),
    "experts": ("data",),
    "vocab": ("model",),
    "ssm_inner": ("model",),
    "embed": ("data",),                # FSDP dim inside the pod
    "batch": ("data",),                # per-client batch sharded in-pod
    "dbatch": ("data",),
    "seq": (),
    "layers": (), "groups": (),
    "cache": ("model",), "kv": (), "hd": (),
    "ssm_state": ("model",),
    "memseq": ("model",),
}


@dataclasses.dataclass(frozen=True)
class Placement:
    mode: str                          # "replicated" | "pod"
    mesh: Any                          # repro_torch.launch.mesh.Mesh
    clients_axes: tuple                # mesh axes stacked into the client dim
    rules: dict

    @property
    def n_clients(self) -> int:
        n = 1
        for a in self.clients_axes:
            n *= self.mesh.shape[a]
        return max(n, 1)


def make_placement(arch_name: str, mesh, *, role: str = "train") -> Placement:
    multi = "pod" in mesh.shape
    if arch_name in POD_AS_CLIENT_ARCHS:
        clients = ("pod",) if multi else ()
        rules = dict(_RULES_POD_CLIENT)
    else:
        clients = ("pod", "data") if multi else ("data",)
        rules = dict(_RULES_REPLICATED)
        if role != "train":
            # serving has no client dim; use data axes for the request batch
            rules["dbatch"] = ("pod", "data") if multi else ("data",)
            rules["batch"] = rules["dbatch"]
    if arch_name in POD_AS_CLIENT_ARCHS and role != "train":
        rules["dbatch"] = ("data",)
        rules["batch"] = ("data",)
    return Placement(
        mode="pod" if arch_name in POD_AS_CLIENT_ARCHS else "replicated",
        mesh=mesh,
        clients_axes=clients,
        rules=rules,
    )


def _axis_size(mesh, axis) -> int:
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]


def spec_for(placement: Placement, axes: tuple[Optional[str], ...],
             shape: tuple[int, ...]) -> tuple:
    """The spec of one array: greedily, divisibility-checked."""
    mesh = placement.mesh
    used: set[str] = set()
    entries: list = []
    for dim, name in zip(shape, axes):
        assigned = None
        if name is not None:
            prefs = placement.rules.get(name, ())
            for cand in prefs:
                cand_axes = (
                    placement.clients_axes if cand == "__clients__" else (cand,)
                )
                if not cand_axes:
                    continue
                if any(a in used for a in cand_axes):
                    continue
                size = _axis_size(mesh, tuple(cand_axes))
                if size > 1 and dim % size == 0:
                    assigned = (
                        cand_axes[0] if len(cand_axes) == 1 else tuple(cand_axes)
                    )
                    used.update(cand_axes)
                    break
        entries.append(assigned)
    # trim trailing Nones for tidiness
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def _shape_of(s) -> tuple:
    """A tensor's shape, a shape itself, or () for a host scalar (a
    cache's ``pos``)."""
    if hasattr(s, "shape"):
        return tuple(s.shape)
    return () if isinstance(s, (int, float)) else tuple(s)


def _map(fn, axes_tree, shapes_tree):
    """``fn(axes, shape)`` over an axes tree (leaves: tuples) and the
    matching tree of tensors / shapes (dicts, lists, namedtuples)."""
    if is_axes_leaf(axes_tree):
        return fn(tuple(axes_tree), shapes_tree)
    if isinstance(axes_tree, dict):
        return {k: _map(fn, a, shapes_tree[k]) for k, a in axes_tree.items()}
    if hasattr(axes_tree, "_fields"):
        return type(axes_tree)(*(_map(fn, a, s)
                                 for a, s in zip(axes_tree, shapes_tree)))
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(_map(fn, a, s)
                               for a, s in zip(axes_tree, shapes_tree))
    raise TypeError(f"not an axes tree node: {type(axes_tree).__name__}")


def tree_shardings(placement: Placement, axes_tree: PyTree,
                   shapes_tree: PyTree) -> PyTree:
    """(axes tree, tensor / shape tree) -> the tree of specs."""
    return _map(lambda a, s: spec_for(placement, a, _shape_of(s)),
                axes_tree, shapes_tree)


def shard_shape(placement: Placement, spec: tuple, shape) -> tuple:
    """The per-device shard shape of an array of ``shape`` under ``spec``."""
    out = list(_shape_of(shape))
    for i, entry in enumerate(spec):
        if entry is not None:
            out[i] //= _axis_size(placement.mesh, entry)
    return tuple(out)


def tree_shard_shapes(placement: Placement, axes_tree: PyTree,
                      shapes_tree: PyTree) -> PyTree:
    """Every leaf's per-device shard shape under the placement's specs."""
    return _map(lambda a, s: shard_shape(
        placement, spec_for(placement, a, _shape_of(s)), s),
        axes_tree, shapes_tree)


def with_client_dim(axes_tree: PyTree) -> PyTree:
    """Prepend the 'clients' logical axis to every leaf's axes tuple."""
    return _map(lambda a, _s: ("clients",) + a, axes_tree, axes_tree)


def scalar_safe(axes_tree: PyTree, shapes_tree: PyTree) -> PyTree:
    """Clip axes tuples that are longer than the actual rank (scalars)."""
    return _map(lambda a, s: a[: len(_shape_of(s))], axes_tree, shapes_tree)
