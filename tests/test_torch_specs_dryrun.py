"""Port parity: ``launch/specs.py``, ``launch/sharding.py`` and the
``meta``-device dry run (``launch/dryrun.py``).

* Every architecture x every ``INPUT_SHAPES`` entry: the port's specs
  (``meta`` tensors) and logical axes against the reference's
  ``jax.eval_shape`` specs.  Where the reference stacks layers on a
  leading axis the port keeps a list of per-layer trees, so each port leaf
  matches the reference leaf of its path with the list indices taken out,
  minus the stacked dims (axes too); a cache's ``pos`` is a host integer.
* ``make_placement`` / ``spec_for`` against the reference on its abstract
  16 x 16 and 2 x 16 x 16 meshes, for every leaf of every architecture's
  DEPOSITUM state (the reference's spec with its stacked-layer entries
  taken out).
* ``state_specs``: five trees (nine compressed) of the reference's
  shapes; Qwen3-1.7B's 2,032,264,192 parameters (vocabulary padded to
  152,064); its 4.065 GB bf16 tree a client, two clients' state fitting
  on the card with the step's temporaries and three not.
"""
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as jget
from repro.launch import sharding as jsh
from repro.launch import specs as jspecs
from repro.models import build_model as j_build
from repro.models.common import is_axes_leaf as j_is_axes_leaf
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.launch import dryrun, sharding, specs
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import build_model

ARCHS = list_archs()
SHAPES = list(INPUT_SHAPES)


@pytest.fixture(scope="module")
def jdry():
    """The reference's ``launch/dryrun.py`` (its ``state_specs``).  It sets
    ``XLA_FLAGS`` for 512 host devices as it is imported: with the backend
    already up that cannot apply here, and the variable is put back."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.training  # noqa: F401  (its modules import in a cycle)
        import repro.launch.dryrun as d
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return d


def _jdt(x) -> str:
    return str(np.dtype(x.dtype))


def _tdt(t) -> str:
    return str(t.dtype).split(".")[-1]


def _j_leaves(shapes, axes):
    """{dotted path: (shape, dtype, axes)} of a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    ax = jax.tree_util.tree_leaves(axes, is_leaf=j_is_axes_leaf)
    out = {}
    for (path, s), a in zip(flat, ax):
        name = ".".join(str(getattr(k, "key", getattr(k, "name", None)))
                        for k in path)
        out[name] = (tuple(s.shape), _jdt(s), tuple(a))
    return out


def _t_leaves(tree, axes, prefix=""):
    """[(dotted path with list indices, tensor, axes)] of a port tree."""
    if isinstance(tree, torch.Tensor):
        return [(prefix[:-1], tree, tuple(axes))]
    if isinstance(tree, (int, float)):
        return []                               # a cache's host ``pos``
    if isinstance(tree, dict):
        return [leaf for k in tree
                for leaf in _t_leaves(tree[k], axes[k], f"{prefix}{k}.")]
    if hasattr(tree, "_fields"):
        return [leaf for f in tree._fields
                for leaf in _t_leaves(getattr(tree, f), getattr(axes, f),
                                      f"{prefix}{f}.")]
    return [leaf for i, (t, a) in enumerate(zip(tree, axes))
            for leaf in _t_leaves(t, a, f"{prefix}{i}.")]


def _match(jl: dict, tl: list, msg: str, lead_dim: int = 0):
    """Every port leaf against the reference leaf of its path with the
    list indices out (``lead_dim``: dims ahead of the stacked ones, the
    state's clients); every reference leaf is covered as often as its
    stacked dims say."""
    seen = {}
    for path, t, a in tl:
        idx = [p for p in path.split(".") if p.isdigit()]
        name = ".".join(p for p in path.split(".") if not p.isdigit())
        assert name in jl, f"{msg}: {path} not in the reference"
        shape, dt, ax = jl[name]
        n = len(idx)
        keep = lambda v: tuple(v[:lead_dim]) + tuple(v[lead_dim + n:])
        assert tuple(t.shape) == keep(shape), (msg, path, t.shape, shape)
        assert a == keep(ax), (msg, path, a, ax)
        assert _tdt(t) == dt, (msg, path, t.dtype, dt)
        seen[name] = seen.get(name, 0) + 1
        seen.setdefault(("lead", name), shape[lead_dim:lead_dim + n])
    for name, (shape, _dt, ax) in jl.items():
        if name.endswith("pos") and name not in seen:
            continue                            # host integers in the port
        lead = seen.get(("lead", name))
        assert lead is not None, f"{msg}: reference leaf {name} not covered"
        assert seen[name] == int(np.prod(lead)), (msg, name, seen[name])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch, shape):
    jcfg, cfg = jget(arch), get_config(arch)
    kind = INPUT_SHAPES[shape][2]
    assert INPUT_SHAPES[shape] == J_SHAPES[shape]
    if kind == "train":
        for n in (1, 16, 32):
            js, ja = jspecs.train_batch_specs(jcfg, shape, n)
            ts, ta = specs.train_batch_specs(cfg, shape, n)
            _match(_j_leaves(js, ja), _t_leaves(ts, ta), f"{arch} {n}")
            assert all(t.device.type == "meta" for t in ts.values())
        return
    if kind == "prefill":
        js, ja = jspecs.prefill_specs(jcfg, shape)
        ts, ta = specs.prefill_specs(cfg, shape)
        _match(_j_leaves(js, ja), _t_leaves(ts, ta), arch)
        return
    assert specs.decode_capacity(cfg, shape) == jspecs.decode_capacity(
        jcfg, shape)
    js, ja = jspecs.decode_cache_specs(jcfg, shape)
    ts, ta = specs.decode_cache_specs(cfg, shape)
    tl = _t_leaves(ts, ta)
    assert all(t.device.type == "meta" for _, t, _ in tl)
    _match(_j_leaves(js, ja), tl, f"{arch} {shape} cache")
    js, ja = jspecs.decode_token_specs(jcfg, shape)
    ts, ta = specs.decode_token_specs(cfg, shape)
    _match(_j_leaves(js, ja), _t_leaves(ts, ta), f"{arch} tokens")


def _abstract(sizes, names):
    from jax.sharding import AbstractMesh
    try:
        return AbstractMesh(sizes, names)
    except TypeError:
        return AbstractMesh(tuple(zip(names, sizes)))


MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _spec_tuple(spec, rank: int) -> tuple:
    """A reference ``PartitionSpec`` as the port's tuple (padded)."""
    entries = tuple(spec) + (None,) * (rank - len(tuple(spec)))
    return entries


def _trim(entries) -> tuple:
    entries = list(entries)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_placement_and_specs_match_reference(arch, mesh, jdry):
    sizes, names = MESHES[mesh]
    jm = _abstract(sizes, names)
    tm = Mesh.abstract(tuple(zip(names, sizes)))
    for role in ("train", "serve"):
        jp = jsh.make_placement(arch, jm, role=role)
        tp = sharding.make_placement(arch, tm, role=role)
        assert (tp.mode, tp.clients_axes, tp.n_clients, tp.rules) == (
            jp.mode, tuple(jp.clients_axes), jp.n_clients, jp.rules)
    jp = jsh.make_placement(arch, jm, role="train")
    tp = sharding.make_placement(arch, tm, role="train")
    n = tp.n_clients
    js, ja = jdry.state_specs(j_build(jget(arch)), n)
    ts, ta = dryrun.state_specs(build_model(get_config(arch), device="meta"),
                                n)
    jl = _j_leaves(js.x, ja.x)
    checked = 0
    for path, t, a in _t_leaves(ts.x, ta.x):
        k = len([p for p in path.split(".") if p.isdigit()])
        name = ".".join(p for p in path.split(".") if not p.isdigit())
        shape, _dt, ax = jl[name]
        want = _spec_tuple(jsh.spec_for(jp, ax, shape), len(shape))
        want = _trim(want[:1] + want[1 + k:])
        got = sharding.spec_for(tp, a, tuple(t.shape))
        assert got == want, (arch, mesh, path, got, want)
        shard = sharding.shard_shape(tp, got, t.shape)
        assert all(s * (1 if e is None else sharding._axis_size(tm, e)) == d
                   for s, e, d in zip(shard, got + (None,) * 9, t.shape))
        checked += 1
    assert checked == len(ts.x)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_specs_match_reference(arch, jdry):
    js, ja = jdry.state_specs(j_build(jget(arch)), 3)
    model = build_model(get_config(arch), device="meta")
    ts, ta = dryrun.state_specs(model, 3)
    for f in ("x", "y", "nu", "mu", "g"):
        _match(_j_leaves(getattr(js, f), getattr(ja, f)),
               _t_leaves(getattr(ts, f), getattr(ta, f)), f"{arch} {f}",
               lead_dim=1)
    jp = sum(int(np.prod(s.shape)) for s in
             jax.tree_util.tree_leaves(js.x)) // 3
    tp = sum(t[0].numel() for t in ts.x.values())
    assert tp == jp
    comp, _ = dryrun.state_specs(model, 3, compressed=True)
    assert len(dryrun._trees(comp)) == 9 and len(dryrun._trees(ts)) == 5


def test_qwen3_full_width_fits_two_bf16_clients():
    r = dryrun.run_one("qwen3-1.7b", "train_4k", mesh="1x1", n_clients=2)
    assert r["params"] == 2_032_264_192
    assert r["tree_bytes_per_client"] == 2 * 2_032_264_192
    assert r["n_trees"] == 5
    assert r["state_bytes"] == r["state_bytes_per_device"] == \
        5 * 2 * 4_064_528_384
    assert r["clients_fit_per_device"] == 2
    for k in ("memory_analysis", "cost_analysis", "cost_corrected",
              "collectives"):
        assert set(r[k]) == {"not_applicable"}
    rl = r["roofline"]
    assert rl["dominant"] in ("compute", "memory", "collective")
    assert rl["model_flops_global"] > 0


@pytest.mark.parametrize("multi", [False, True])
def test_production_mesh_dryrun_every_shape(multi):
    """The reference's production mesh, every shape of Qwen3-1.7B: one
    client a data row, a model-parallel share of each tree a device."""
    mesh = make_production_mesh(multi_pod=multi)
    assert mesh.size == (512 if multi else 256)
    for shape in SHAPES:
        r = dryrun.run_one("qwen3-1.7b", shape, multi_pod=multi)
        assert r["chips"] == mesh.size and r["mesh"] == mesh.shape
        if r["kind"] == "train":
            assert r["n_clients"] == (32 if multi else 16)
            # the clients shard over data; model splits each tree further
            assert r["state_bytes_per_device"] < r["state_bytes"] / \
                r["n_clients"]
            assert r["collective_bytes_per_device"] > 0
        elif r["kind"] == "prefill":
            assert 0 < r["param_bytes_per_device"] < r["param_bytes"]
        else:
            assert r["cache_bytes_per_device"] > 0


def test_dryrun_cli_writes_one_json_an_arch(tmp_path, capsys):
    res = dryrun.main(["--arch", "all", "--shape", "train_4k", "--mesh",
                       "1x1", "--out", str(tmp_path)])
    assert [r["arch"] for r in res] == ARCHS
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert [l["arch"] for l in lines] == ARCHS
    files = sorted(os.listdir(tmp_path))
    assert len(files) == len(ARCHS) and all(
        re.match(r".+__train_4k__1x1__dense\.json$", f) for f in files)
    with pytest.raises(SystemExit):
        dryrun.main(["--shape", "nope"])
