"""Port parity: the distributed backends over ``torch.distributed``.

The reference's ``tests/test_distributed.py`` (``slow``) runs its
shard_map over 8 forced host devices and holds it to the single-process
host results at 1e-5.  Here gloo groups of 4 and 2 CPU processes
(``tests/_torch_dist_worker.py``, one spawn a suite, each under its own
timeout, a ``FileStore`` in ``tmp_path``) run the port's
``ShardMapBackend``: every process holds its block of the client axis,
and each case is held against the reference's single-process run of the
same problem, computed here in the parent on the CPU:

* ``shard_body`` of every kind, at one client a rank and at two;
* ``launch.gossip_dist``'s placement mixers for every topology, and the
  ``core.gossip`` collective mixers;
* every schedule kind over 5 rounds of T0 = 3, cohorts with the
  reference's masks injected, compressed schedules through the packed
  ``wire_fn`` (the reference's uniforms injected);
* one comm step and 5 DEPOSITUM steps (the reference's host test), with
  ``stationarity_metrics`` reduced over the group;
* a stacked-W topology sweep with a circulant point, and a schedule grid;
* a ``FederatedTrainer`` run (loss and recorded metrics reduced over the
  group), an ``AsyncTrainer`` run and ``sweep_run_fedalg`` (a server mean,
  a gossip);
* ``launch.train`` under ``torchrun`` (shard_map picked for the group)
  against the one-process run's losses.

Bit equality where the arithmetic is the same sequence (circulant and
identity mixes against the port's stacked version, a constant schedule
against its plan, a full cohort against a constant schedule, ``none``
against the dense path); the counted collective bytes
(``analysis/hlo.py``) equal ``analysis.comm.device_wire_bytes``.
"""
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist_worker as W
from repro.core import CohortSampler as JSampler
from repro.core import DepositumConfig as JConfig
from repro.core import MixPlan as JPlan
from repro.core import MixSchedule as JSched
from repro.core import compression as jc
from repro.core import init as j_init
from repro.core import local_then_comm_round as j_round
from repro.core import pad_plan as j_pad_plan
from repro.core import schedule as jsch
from repro.core import stack_hypers as j_stack_hypers
from repro.core import stack_mixplans as j_stack_mixplans
from repro.core import stationarity_metrics as j_metrics
from repro.core import step as j_step
from repro.core.gossip import (circulant_from_mixer_spec, make_dense_mixer,
                               torus_circulant_spec)
from repro.core.mixing import apply_mix as j_apply_mix
from repro.core.topology import mixing_matrix

TOL = 1e-5
WORKER = Path(W.__file__).resolve()
SPAWN_TIMEOUT = 120


def _spawn(suite: str, world: int, tmp: Path, env: dict) -> dict:
    """Run ``suite`` on a gloo group of ``world`` processes; returns the
    ranks' results assembled: client rows concatenated in rank order
    (``s:`` keys on dim 1), ``r:`` keys from rank 0."""
    store = tmp / f"store_{suite}"
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), suite, str(r), str(world), str(store),
         str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env={**os.environ, **env}) for r in range(world)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=SPAWN_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if p.returncode:
            errs.append(err[-3000:])
    assert not errs, errs[0]
    ranks = [dict(np.load(tmp / f"{suite}_{r}.npz")) for r in range(world)]
    out = {}
    for k in ranks[0]:
        if k.startswith("r:"):
            out[k[2:]] = ranks[0][k]
        elif k.startswith("s:"):
            out[k[2:]] = np.concatenate([r[k] for r in ranks], axis=1)
        else:
            out[k] = np.concatenate([r[k] for r in ranks], axis=0)
    return out


def _close(got, want, tol=TOL, msg=""):
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    assert err < tol, f"{msg}: max abs err {err}"


# ---------------------------------------------------------------------------
# the reference's single-process runs
# ---------------------------------------------------------------------------

def _j_grad(n, d=W.D):
    A, b = (jnp.asarray(v) for v in W.lsq(n, d))

    def grad_fn(w, batch):
        r = jnp.einsum("nmd,nd->nm", A, w) - b
        return jnp.einsum("nmd,nm->nd", A, r) / W.M, {}

    return grad_fn


def _j_rounds(mixer, n, *, d=W.D, n_max=None, compress=None):
    st = j_init(jnp.zeros(d), n, n_max=n_max, compress=compress)
    rnd = jax.jit(functools.partial(
        j_round, grad_fn=_j_grad(n_max or n, d), config=JConfig(**W.CFG),
        mixer=mixer))
    for _ in range(W.ROUNDS):
        st, _ = rnd(st, batches=jnp.zeros((W.T0, 1)))
    return st


def _held(got: dict, name: str, st, tol=TOL):
    for f in ("x", "y", "nu", "g"):
        want = getattr(st, f)
        want = want["w"] if isinstance(want, dict) else want
        _close(got[f"{name}/{f}"], want, tol, f"{name} {f}")


def _j_schedules(world):
    n = 2 * world
    Wr = mixing_matrix("ring", n)
    pc = JPlan.circulant(*W.ring(world))
    return {
        "constant": JSched.constant(JPlan.dense(Wr)),
        "stacked": JSched.stacked([JPlan.dense(mixing_matrix(t, n)) for t in
                                   ("ring", "star", "complete", "torus",
                                    "ring")]),
        "alternating": JSched.alternating(
            [JPlan.dense(Wr), JPlan.dense(mixing_matrix("star", n))]),
        "lazy-dense": JSched.lazy(JPlan.dense(Wr), 0.6, rounds=W.ROUNDS,
                                  seed=3),
        "lazy-circulant": JSched.lazy(pc, 0.5, rounds=W.ROUNDS, n=world,
                                      seed=7),
        "chebyshev": JSched.chebyshev(pc, 3, n=world),
        "chebyshev-dense": JSched.chebyshev(JPlan.dense(Wr), 2),
    }


def _j_cohorts(n_max):
    Wd = JPlan.dense(mixing_matrix("ring", n_max))
    return {
        "full": JSched.cohort(Wd, JSampler.full(n_max)),
        "bernoulli": JSched.cohort(Wd, JSampler.bernoulli(0.6, n_max,
                                                          seed=3)),
        "fixed": JSched.cohort(Wd, JSampler.fixed_size(3, n_max, seed=5)),
        "padded": JSched.cohort(
            j_pad_plan(JPlan.from_topology("ring", 5), n_max),
            JSampler.bernoulli(0.7, n_max, seed=9, n_eff=5)),
    }


def _j_compressed(world):
    n = 2 * world
    dense = jsch.as_schedule(JPlan.dense(mixing_matrix("ring", n)))
    circ = jsch.as_schedule(JPlan.circulant(*W.ring(world)))
    return {
        "topk-sim": dense.with_compression(jc.CompressionSpec.topk(0.25)),
        "topk-wire": dense.with_compression(
            jc.CompressionSpec.topk(0.25, wire_k=16)),
        "randk-wire": dense.with_compression(
            jc.CompressionSpec.randk(0.25, seed=4, wire_k=32)),
        "qsgd-wire": dense.with_compression(jc.CompressionSpec.qsgd(
            4, seed=5)),
        "topk-wire-circulant": circ.with_compression(
            jc.CompressionSpec.topk(0.25, wire_k=16)),
    }


def _mix_inputs(tmp: Path, world: int) -> dict:
    """The reference's cohort masks and compression uniforms, for the
    workers to inject."""
    n = 2 * world
    masks = {name: np.stack([np.asarray(s.sampler.mask_at(r), np.float32)
                             for r in range(W.ROUNDS)])
             for name, s in _j_cohorts(n).items()}
    draws = {}
    for tag, spec in (("randk", jc.CompressionSpec.randk(0.25, seed=4)),
                      ("qsgd", jc.CompressionSpec.qsgd(4, seed=5))):
        for r in range(W.ROUNDS):
            for var in (0, 1):
                k = jax.random.fold_in(jax.random.fold_in(
                    jax.random.fold_in(spec.key, r), var), 0)
                draws[f"{tag}/{r}_{var}_0"] = np.asarray(
                    jax.random.uniform(k, (n, W.DC)))
    np.savez(tmp / "masks.npz", **masks)
    np.savez(tmp / "draws.npz", **draws)
    return {"DIST_COHORT_MASKS": str(tmp / "masks.npz"),
            "DIST_DRAWS": str(tmp / "draws.npz")}


# ---------------------------------------------------------------------------
# the suites: one spawn each, shared by the tests of the module
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mix(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mix")
    return _spawn("mix", 4, tmp, _mix_inputs(tmp, 4))


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    return _spawn("sweep", 4, tmp_path_factory.mktemp("sweep"), {})


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    return _spawn("trainers", 2, tmp_path_factory.mktemp("trainers"), {})


WORLD = 4


@pytest.mark.parametrize("n", [WORLD, 2 * WORLD])
def test_shard_body_every_kind(mix, n):
    x = jnp.asarray(W.mix_input(n))
    Wr = mixing_matrix("ring", n)
    plans = {"complete": JPlan.complete(), "identity": JPlan.identity(),
             "dense": JPlan.dense(Wr),
             "cheb_dense": JPlan.chebyshev(JPlan.dense(Wr), 2)}
    if n == WORLD:
        plans["circulant"] = JPlan.circulant(*W.ring(n))
        plans["cheb_circulant"] = JPlan.chebyshev(
            JPlan.circulant(*W.ring(n)), 3, n=n)
    for name, plan in plans.items():
        _close(mix[f"mix{n}/{name}"], j_apply_mix(plan, x), TOL,
               f"shard_body {name} n={n}")
    # the same op sequence as the port's stacked mix: bit for bit
    # (complete is an all-reduce sum, then a division: another order)
    for name in ("identity",) + (
            ("circulant", "cheb_circulant") if n == WORLD else ()):
        assert mix[f"mixbits{n}/{name}"], (name, n)


def test_placement_and_gossip_mixers_every_topology(mix):
    x = np.asarray(W.mix_input(WORLD, seed=3).reshape(WORLD, 15))
    for topo in W.TOPOS:
        _close(mix[f"place/{topo}"],
               make_dense_mixer(mixing_matrix(topo, WORLD))(x), TOL, topo)
    ring = make_dense_mixer(mixing_matrix("ring", WORLD))(x)
    _close(mix["place/ring_adapter"], ring, TOL, "ring adapter")
    _close(mix["gossip/ring"], ring, TOL, "ring_mixer")
    _close(mix["gossip/torus"], circulant_from_mixer_spec(
        WORLD, *torus_circulant_spec(WORLD)) @ x, TOL, "torus_mixer")
    _close(mix["gossip/complete"], np.broadcast_to(x.mean(0), x.shape), TOL,
           "complete mixer")


@pytest.mark.parametrize("name", list(_j_schedules(WORLD)))
def test_schedule_kinds_match_reference(mix, name):
    n = WORLD if name in ("lazy-circulant", "chebyshev") else 2 * WORLD
    _held(mix, f"sched/{name}", _j_rounds(_j_schedules(WORLD)[name], n))
    if name == "constant":
        assert mix["const_bits"], "constant schedule not bit-exact on shards"


@pytest.mark.parametrize("name", ["full", "bernoulli", "fixed", "padded"])
def test_cohorts_match_reference_with_its_masks(mix, name):
    padded = name == "padded"
    ref = _j_rounds(_j_cohorts(2 * WORLD)[name], 5 if padded else 2 * WORLD,
                    n_max=2 * WORLD if padded else None)
    _held(mix, f"cohort/{name}", ref)
    if padded:          # padding rows frozen on the shard path too
        assert not np.any(mix["cohort/padded/x"][5:])
        assert not np.any(mix["cohort/padded/y"][5:])
    if name == "full":
        assert mix["full_cohort_bits"], "full cohort not bit-exact"


@pytest.mark.parametrize("name", list(_j_compressed(WORLD)))
def test_compressed_schedules_through_the_wire(mix, name):
    s = _j_compressed(WORLD)[name]
    n = WORLD if name.endswith("circulant") else 2 * WORLD
    assert bool(mix[f"wire/{name}"]) == (name != "topk-sim"), name
    # rand-k rescales by 1 / rate (the reference's own 1e-4)
    _held(mix, f"comp/{name}", _j_rounds(s, n, d=W.DC, compress=s),
          1e-4 if name.startswith("randk") else TOL)
    if name == "topk-wire":
        _close(mix["comp/topk-sim/x"], mix["comp/topk-wire/x"], 1e-6,
               "packed wire != dense-q collective")
        assert mix["none_bits"], "spec=none not bit-exact on shards"


def test_depositum_steps_and_metrics_equal_host(mix):
    """One comm step and 5 steps of the reference's host test, and the
    stationarity metrics reduced over the group."""
    n = 2 * WORLD
    A, b = (jnp.asarray(v) for v in W.spd(n))

    def grad_fn(x, batch):
        return jnp.einsum("nij,nj->ni", A, x) - b, {}

    cfg = JConfig(alpha=0.05, beta=1.0, gamma=0.5, comm_period=1,
                  prox_name="l1", prox_kwargs={"lam": 1e-3})
    mixer = make_dense_mixer(mixing_matrix("ring", n))
    st = j_init(jnp.zeros(32), n)
    for i in range(5):
        st, _ = j_step(st, None, grad_fn, cfg, mixer, is_comm_step=True)
        if i == 0:
            _held(mix, "step1", st)
    _held(mix, "step5", st)
    gf = lambda x: grad_fn(x, None)[0]
    met = j_metrics(st, {"global_at": gf, "local_at": gf}, cfg)
    for k, v in met.items():
        np.testing.assert_allclose(mix[f"metrics/{k}"], np.asarray(v),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("name", ["dense", "circulant", "complete",
                                  "topk-wire", "qsgd-wire"])
def test_counted_collective_bytes_equal_the_wire_model(mix, name):
    counted, model = mix[f"bytes/{name}"]
    assert counted == model and counted > 0, (name, counted, model)


def _j_sweep(n, plan, S, seq=True):
    from repro.core import Hyper
    from repro.training.sweep import sweep_run, sweep_run_sequential

    cfg = JConfig(momentum="polyak", comm_period=W.T0, prox_name="l1",
                  prox_kwargs={"lam": 1e-3})
    h = Hyper.create(alpha=0.05, beta=1.0, gamma=0.5, lam=1e-3)
    run = sweep_run_sequential if seq else sweep_run
    fs, _ = run(jnp.zeros(W.D), _j_grad(n), cfg, plan,
                j_stack_hypers([h] * S), jnp.zeros((W.ROUNDS, W.T0, 1)),
                n_clients=n)
    return np.asarray(fs.x)


def test_topology_sweep_with_a_circulant_point(sweeps):
    n = 2 * WORLD
    plans = j_stack_mixplans([JPlan.from_topology(t, n) for t in W.TOPOS])
    _close(sweeps["topo"], _j_sweep(n, plans, len(W.TOPOS)), TOL,
           "topology sweep")
    # the circulant (ppermute) point = the dense ring point
    _close(sweeps["circulant"], _j_sweep(WORLD, j_stack_mixplans(
        [JPlan.dense(mixing_matrix("ring", WORLD))]), 1, seq=False), TOL,
        "circulant sweep point")


def test_schedule_grid_sweep(sweeps):
    from repro.core import as_stacked_schedule, stack_schedules

    n = 2 * WORLD
    base = JPlan.dense(mixing_matrix("ring", n))
    native = ([JSched.lazy(base, p, rounds=W.ROUNDS, seed=2)
               for p in (0.3, 0.6, 1.0)]
              + [JSched.chebyshev(base, k) for k in (2, 3)])
    grid = stack_schedules([as_stacked_schedule(s, W.ROUNDS, n)
                            for s in native])
    want = _j_sweep(n, grid, len(native))
    _close(sweeps["sched_grid"], want, TOL, "schedule grid")
    _close(sweeps["lazy_grid"], want[:3], TOL, "native lazy grid")


def _j_model():
    from typing import NamedTuple

    class JModel(NamedTuple):
        cfg: object
        init: object
        forward_train: object
        loss: object
        forward_decode: object
        init_decode_cache: object

    def loss(params, batch):
        e = batch["x"] @ params["w"] - batch["y"]
        return jnp.mean(e * e), {}

    return JModel(None, lambda key: ({"w": jnp.zeros((W.D,))}, None), None,
                  loss, None, None)


def _j_trainer_setup(n):
    from repro.training.train_loop import TrainerConfig
    tc = TrainerConfig(n_clients=n, topology="ring", log_every=1,
                       depositum=JConfig(alpha=0.05, comm_period=W.T0,
                                         prox_name="l1",
                                         prox_kwargs={"lam": 1e-4}))
    jb = [{k: jnp.asarray(v) for k, v in b.items()}
          for b in W.trainer_batches(n, W.ROUNDS)]
    return tc, jb


def test_federated_trainer_reduces_over_the_group(trainers):
    from repro.training.train_loop import FederatedTrainer
    n = 4
    tc, jb = _j_trainer_setup(n)
    tr = FederatedTrainer(_j_model(), tc, telemetry=True)
    st, hist = tr.run(tr.init_state(jax.random.PRNGKey(0)), iter(jb),
                      W.ROUNDS)
    _held(trainers, "trainer", st)
    np.testing.assert_allclose(trainers["trainer/loss"],
                               [r["loss"] for r in hist], rtol=1e-5)
    np.testing.assert_allclose(trainers["trainer/consensus_x"],
                               [r["consensus_x"] for r in hist], rtol=1e-4,
                               atol=1e-9)
    _close(trainers["trainer/mean"], np.asarray(st.x["w"]).mean(0), TOL,
           "mean_params")


def test_async_trainer_through_the_backend(trainers):
    from repro.core.staleness import StragglerModel
    from repro.training.async_runtime import (AsyncConfig, AsyncTrainer,
                                              tabulate_batches)
    n = 4
    tc, jb = _j_trainer_setup(n)
    at = AsyncTrainer(_j_model(), tc, straggler=StragglerModel.exponential(
        1.0, n, seed=3), async_cfg=AsyncConfig(tau=2))
    ast, _ = at.run(at.init_state(jax.random.PRNGKey(0)),
                    tabulate_batches(iter(jb), W.ROUNDS), W.ROUNDS)
    _held(trainers, "async", ast)
    assert int(trainers["async/applies"]) == sum(
        e["type"] == "apply" for e in at.events)


@pytest.mark.parametrize("name", ["fedmid", "dsgd"])
def test_fedalg_sweep_through_the_backend(trainers, name):
    from repro.core import Hyper
    from repro.core.fedopt import FedAlgConfig, make_algorithm
    from repro.training.sweep import sweep_run_fedalg
    n = 4
    A, b = (jnp.asarray(v) for v in W.lsq(n))

    def grad_fn(w, batch):
        r = jnp.einsum("nmd,nd->nm", A, w) - b
        return jnp.einsum("nmd,nm->nd", A, r) / W.M, {}

    Wm = mixing_matrix("ring", n) if name == "dsgd" else None
    alg = make_algorithm(name, FedAlgConfig(
        local_steps=W.T0, alpha=0.05, prox_name="l1",
        prox_kwargs={"lam": 1e-3}, W=Wm))
    final, _ = sweep_run_fedalg(
        alg, jnp.zeros(W.D), grad_fn,
        Hyper.create(alpha=0.05, beta=1.0, gamma=0.5, lam=1e-3),
        jnp.zeros((W.ROUNDS, W.T0, 1)), n_clients=n,
        plan=None if Wm is None else JPlan.dense(Wm))
    _close(trainers[f"fed/{name}"].reshape(-1, n, W.D),
           np.asarray(final.x).reshape(-1, n, W.D), TOL, name)


def test_train_launcher_over_a_gloo_group(tmp_path):
    """``launch.train`` under ``torchrun`` (two CPU processes, two clients
    each): the backend follows the processes present (shard_map, as
    ``suggest_backend`` picks for the dense plan), and the logged losses
    are the one-process run's, reduced over the group."""
    import json

    from repro_torch.launch import train

    argv = ["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu",
            "--clients", "4", "--rounds", "2", "--log-every", "1"]
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "repro_torch.launch.train", *argv],
        capture_output=True, text=True,
        timeout=SPAWN_TIMEOUT, cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": str(WORKER.parents[1] / "src")})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "2 processes, rows slice(0, 2, None)" in proc.stdout
    got = [json.loads(l)["loss"] for l in proc.stdout.splitlines()
           if l.startswith("{")]
    _, _, hist = train.main(argv)
    np.testing.assert_allclose(got, [h["loss"] for h in hist], rtol=1e-5)


# ---------------------------------------------------------------------------
# one process: the client axis of a process holding every client
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_local_axis_reductions_are_the_stacked_means(dtype):
    """``LOCAL_AXIS``'s client reductions: the mean over the client dim
    (bit for bit ``torch.mean`` on the CPU, fp32 accumulation), a weighted
    mean over a sub-population (plain and on a sweep's dim 1), and
    ``take`` returning what it was given."""
    import torch

    from repro_torch.launch.mesh import LOCAL_AXIS

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(5)
    v = torch.from_numpy(rng.standard_normal((6, 4, 3)).astype(np.float32))
    v = v.to(dt)
    assert torch.equal(LOCAL_AXIS.client_mean(v), torch.mean(v, dim=0))
    assert torch.equal(LOCAL_AXIS.client_mean(v, 1), torch.mean(v, dim=1))
    w = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0, 1.0])
    want = (v.float()[w > 0].sum(0) / 4).to(dt)
    np.testing.assert_allclose(
        LOCAL_AXIS.client_mean(v, 0, w).float().numpy(),
        want.float().numpy(), atol=1e-6,
        rtol=1e-5 if dtype == "float32" else 1e-2)
    ws = w[None, :4].expand(6, 4)
    got = LOCAL_AXIS.client_mean(v, 1, ws)
    want = (v.float()[:, ws[0] > 0].sum(1) / ws[0].sum()).to(dt)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=1e-6,
                               rtol=1e-5 if dtype == "float32" else 1e-2)
    tree = {"a": v, "b": (v, None)}
    assert LOCAL_AXIS.take(tree, dim=1) is tree
    assert torch.equal(LOCAL_AXIS.client_sum(v), v.float().sum(0))


def test_counting_copies_the_backend_and_counts_every_collective():
    """``counting`` returns a copy whose axis counts; the backend it was
    given, and the mixers built from it, count nothing."""
    import torch

    from repro_torch.analysis.hlo import (CountingAxis, collective_bytes,
                                          counting, parse_collectives)
    from repro_torch.core import MixPlan
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training.backends import get_backend

    be = get_backend("shard_map", mesh=make_host_mesh(1, 1), axis_name="data",
                     n_clients=3)
    plan = MixPlan.dense(mixing_matrix("ring", 3), device="cpu")
    before = be.mixer_for(plan)
    counted = counting(be)
    assert isinstance(counted.axis, CountingAxis)
    assert not isinstance(be.axis, CountingAxis)
    tree = {"w": torch.ones(3, 4), "b": torch.ones(3, 2)}
    before(tree)
    assert counted.axis.records == []
    counted.mixer_for(plan)(tree)
    assert parse_collectives(counted.axis) == {
        "all-gather": {"count": 2, "bytes": 3 * 6 * 4}}
    counted.axis.reset()
    assert collective_bytes(counted.axis) == 0


def test_neighbor_mixer_needs_one_client_a_process():
    """The gossip neighbour mixer is the circulant plan's ``shard_mixer``:
    one client a process, else ``ValueError``; on a one-process axis it
    mixes a lone client as the plan does."""
    import torch

    from repro_torch.core.gossip import make_complete_mixer, \
        make_neighbor_mixer
    from repro_torch.launch.mesh import LOCAL_AXIS

    with pytest.raises(ValueError, match="axis of 3 processes"):
        make_neighbor_mixer(LOCAL_AXIS, [(+1, 1 / 3), (-1, 1 / 3)], 1 / 3, 3,
                            device="cpu")
    x = {"w": torch.arange(4.0)[None]}
    mix = make_neighbor_mixer(LOCAL_AXIS, [(+1, 0.5)], 0.5, 1, device="cpu")
    assert torch.equal(mix(x)["w"], x["w"])
    assert torch.equal(make_complete_mixer(LOCAL_AXIS)(x)["w"], x["w"])
