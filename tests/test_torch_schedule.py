"""Port parity: round-indexed schedules.

Every ``MixSchedule`` kind built the same way in both packages gives the
same round plans (``plan_at``) and the same mix (``apply_schedule``) at
rtol 1e-6 / atol 1e-7 (one product of fp32 values, summed in another
order); ``lazy``'s numpy draws are equal exactly, and so are
``stack_schedules`` / ``as_stacked_schedule`` leaves and what
``validate_schedule`` refuses; ``schedule_spectral_lambda`` agrees at
1e-6.  A schedule swept on ``(S, n, ...)`` leaves equals each point mixed
alone (rtol 1e-6), and a reduced Fig. 8 grid through ``sweep_run`` matches
the reference's at the ``test_torch_sweep.py`` tolerances.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import apply_mlp, ce_loss as j_ce, init_mlp
from repro.core import DepositumConfig as JConfig
from repro.core import MixPlan as JPlan
from repro.core import schedule as jsch
from repro.core import stack_hypers as j_stack_hypers
from repro.core import stationarity_metrics as j_metrics
from repro.core.topology import mixing_matrix
from repro.data import make_classification
from repro.training import backends as jbk
from repro.training.sweep import sweep_run as j_sweep_run
from repro_torch.convert import params_from_numpy, state_to_numpy
from repro_torch.core import (CohortSampler, DepositumConfig, MixPlan,
                              MixSchedule, apply_schedule,
                              apply_schedule_sweep, as_schedule,
                              as_stacked_schedule,
                              schedule_spectral_lambda, stack_hypers,
                              stack_schedules, stationarity_metrics, step,
                              validate_schedule)
from repro_torch.core import depositum as tdep
from repro_torch.core.schedule import (shard_compressed_qmix,
                                       shard_schedule_body, wire_supported)
from repro_torch.models.classifier import (MLP, client_grad_fn,
                                           stationarity_grad_fns)
from repro_torch.training.backends import _plan_kind
from repro_torch.training.sweep import sweep_run

N, D, ROUNDS = 6, 5, 4
MIX_TOL = dict(rtol=1e-6, atol=1e-7)


def _w(topo="ring", n=N):
    return mixing_matrix(topo, n)


def _build(pkg, kind):
    """The same schedule in the reference (``pkg`` "j") or the port."""
    if pkg == "j":
        Plan, Sched = JPlan, jsch.MixSchedule
        dense = lambda W: JPlan.dense(W)
        circ = lambda ow, sw: JPlan.circulant(ow, sw)
    else:
        Plan, Sched = MixPlan, MixSchedule
        dense = lambda W: MixPlan.dense(W, device="cpu")
        circ = lambda ow, sw: MixPlan.circulant(ow, sw, device="cpu")
    ring = [(+1, 1 / 3), (-1, 1 / 3)]
    if kind == "constant":
        return Sched.constant(dense(_w("star")))
    if kind == "stacked":
        return Sched.stacked([dense(_w(t)) for t in ("ring", "star",
                                                      "complete")])
    if kind == "alternating":
        return Sched.alternating([dense(_w("ring")), dense(_w("torus"))])
    if kind == "lazy":
        return Sched.lazy(dense(_w("torus")), 0.5, rounds=ROUNDS, seed=3)
    if kind == "lazy_circulant":
        return Sched.lazy(circ(ring, 1 / 3), 0.6, rounds=ROUNDS, n=N,
                          rng=np.random.default_rng(11))
    if kind == "chebyshev":
        return Sched.chebyshev(dense(_w("ring")), 3)
    if kind == "chebyshev_circulant":
        return Sched.chebyshev(circ(ring, 1 / 3), 2, n=N)
    raise ValueError(kind)


KINDS = ["constant", "stacked", "alternating", "lazy", "lazy_circulant",
         "chebyshev", "chebyshev_circulant"]


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((N, D)).astype(np.float32),
            "b": rng.standard_normal((N, 2, 3)).astype(np.float32)}


def _dense_np(plan, pkg):
    if pkg == "j":
        from repro.core import as_dense
        return np.asarray(as_dense(plan, N).W)
    from repro_torch.core import as_dense
    return as_dense(plan, N, device="cpu").W.numpy()


@pytest.mark.parametrize("kind", KINDS)
def test_schedule_kind_matches_reference(kind):
    js, ts = _build("j", kind), _build("t", kind)
    assert ts.kind == js.kind and ts.n_rounds == js.n_rounds
    if js.active is not None:
        np.testing.assert_array_equal(ts.active.numpy(),
                                      np.asarray(js.active))
    tree = _tree()
    for r in range(ROUNDS + 2):                     # past the end: clamps
        np.testing.assert_allclose(_dense_np(ts.plan_at(r), "t"),
                                   _dense_np(js.plan_at(r), "j"), **MIX_TOL)
        jo = jsch.apply_schedule(js, r, jax.tree_util.tree_map(jnp.asarray,
                                                               tree))
        to = apply_schedule(ts, r, {k: torch.from_numpy(v)
                                    for k, v in tree.items()})
        for k in tree:
            np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                       err_msg=f"{kind} r={r} {k}",
                                       **MIX_TOL)
    validate_schedule(ts, N)
    np.testing.assert_allclose(schedule_spectral_lambda(ts, N, ROUNDS),
                               jsch.schedule_spectral_lambda(js, N, ROUNDS),
                               rtol=1e-6)


def test_stacking_densifying_and_validation_match_reference():
    # a p_active grid of lazy schedules stacks directly
    lazies = {pkg: [_build(pkg, "lazy")] + [
        (jsch.MixSchedule if pkg == "j" else MixSchedule).lazy(
            JPlan.dense(_w("torus")) if pkg == "j"
            else MixPlan.dense(_w("torus"), device="cpu"), p,
            rounds=ROUNDS, seed=5) for p in (0.2, 0.9)] for pkg in "jt"}
    jg, tg = (jsch.stack_schedules(lazies["j"]),
              stack_schedules(lazies["t"]))
    assert tg.is_stacked and tg.n_sweep == jg.n_sweep == 3
    np.testing.assert_array_equal(tg.active.numpy(), np.asarray(jg.active))
    for s in range(3):
        np.testing.assert_array_equal(tg.point(s).active.numpy(),
                                      np.asarray(jg.point(s).active))
    # heterogeneous kinds densify to per-round W and stack
    for kind in ("lazy", "chebyshev", "alternating"):
        jd = jsch.as_stacked_schedule(_build("j", kind), ROUNDS, N)
        td = as_stacked_schedule(_build("t", kind), ROUNDS, N)
        np.testing.assert_allclose(td.plan.W.numpy(), np.asarray(jd.plan.W),
                                   **MIX_TOL)
    het = stack_schedules([as_stacked_schedule(_build("t", k), ROUNDS, N)
                           for k in ("lazy", "chebyshev")])
    assert het.n_sweep == 2 and het.n_rounds == ROUNDS
    np.testing.assert_allclose(
        schedule_spectral_lambda(het, N, ROUNDS),
        jsch.schedule_spectral_lambda(jsch.stack_schedules(
            [jsch.as_stacked_schedule(_build("j", k), ROUNDS, N)
             for k in ("lazy", "chebyshev")]), N, ROUNDS), rtol=1e-6)
    with pytest.raises(ValueError, match="heterogeneous"):
        stack_schedules([_build("t", "lazy"), _build("t", "chebyshev")])
    # a defective base (rows sum to 2) is refused by both
    bad = np.eye(N, dtype=np.float32) * 2.0
    with pytest.raises(ValueError, match="rows"):
        jsch.validate_schedule(jsch.MixSchedule.lazy(JPlan.dense(bad), 0.5,
                                                     rounds=2), N)
    with pytest.raises(ValueError, match="rows"):
        validate_schedule(MixSchedule.lazy(MixPlan.dense(bad, device="cpu"),
                                           0.5, rounds=2), N)
    for pkg in ("j", "t"):
        with pytest.raises(TypeError, match="CompressionSpec"):
            _build(pkg, "constant").with_compression(object())
    # the per-shard bodies have landed: on one process (a size-1 axis
    # holding every client) each round's mix is the stacked one bit for
    # bit, the grid's points included; wire_supported decides as the
    # reference's does (the per-rank gloo runs: test_torch_distributed.py)
    from repro_torch.launch.mesh import ShardAxis
    ax = ShardAxis("clients", 1, 0)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, N, 5)).astype(np.float32))
    for r in range(ROUNDS):
        assert torch.equal(shard_schedule_body(tg, r, x, ax, 1, sweep=True),
                           apply_schedule_sweep(tg, r, {"w": x})["w"])
        one = tg.point(1)
        assert torch.equal(shard_schedule_body(one, r, x[1], ax, 1),
                           apply_schedule(one, r, {"w": x[1]})["w"])
    assert wire_supported(tg) == jsch.wire_supported(jg) is False
    assert shard_compressed_qmix.__module__ == "repro_torch.core.schedule"
    plan = MixPlan.dense(_w(), device="cpu")
    assert as_schedule(plan) == MixSchedule.constant(plan)
    assert as_schedule(het) is het
    cheb = _build("t", "chebyshev_circulant")
    assert (_plan_kind(cheb), _plan_kind(het), _plan_kind(plan)) == (
        jbk._plan_kind(_build("j", "chebyshev_circulant")), "dense",
        "dense") == ("circulant", "dense", "dense")


@pytest.mark.parametrize("kind", ["stacked", "lazy", "lazy_circulant",
                                  "chebyshev_circulant", "cohort"])
def test_swept_schedule_equals_each_point_alone(kind):
    if kind == "cohort":
        pts = [MixSchedule.cohort(MixPlan.dense(_w(), device="cpu"),
                                  CohortSampler.bernoulli(p, N, seed=s,
                                                          device="cpu"))
               for p, s in ((0.5, 1), (0.8, 2))]
    elif kind == "chebyshev_circulant":
        ring = [(+1, 1 / 3), (-1, 1 / 3)]
        pts = [MixSchedule.chebyshev(MixPlan.circulant(
            ring, 1 / 3, device="cpu"), 2, n=N)] * 2
    else:
        pts = [_build("t", kind), _build("t", kind)]
        if kind == "stacked":
            pts[1] = MixSchedule.stacked([MixPlan.dense(_w(t), device="cpu")
                                          for t in ("torus", "ring",
                                                    "ring")])
    grid = stack_schedules(pts)
    trees = [_tree(s) for s in range(2)]
    swept = {k: torch.from_numpy(np.stack([t[k] for t in trees]))
             for k in trees[0]}
    for r in range(3):
        out = apply_schedule_sweep(grid, r, swept)
        for s in range(2):
            one = apply_schedule(pts[s], r, {k: torch.from_numpy(v)
                                             for k, v in trees[s].items()})
            for k in one:
                np.testing.assert_allclose(out[k][s].numpy(),
                                           one[k].numpy(), **MIX_TOL)
    # a shared (unswept) schedule mixes every point the same way
    shared = apply_schedule_sweep(pts[0], 1, swept)
    for s in range(2):
        one = apply_schedule(pts[0], 1, {k: torch.from_numpy(v)
                                         for k, v in trees[s].items()})
        np.testing.assert_allclose(shared["a"][s].numpy(), one["a"].numpy(),
                                   **MIX_TOL)


def test_step_runs_a_schedule_like_its_plan():
    """A constant schedule runs exactly its plan's ops, and so does one
    carrying a ``none`` CompressionSpec (the dense path, no memory)."""
    def grad_fn(x, batch):
        return {k: 0.1 * v for k, v in x.items()}, {}

    rng = np.random.default_rng(0)
    st = tdep.init({"w": torch.from_numpy(rng.standard_normal(D).astype(
        np.float32))}, N, device="cpu")
    st = st._replace(x={"w": st.x["w"] + torch.from_numpy(
        rng.standard_normal((N, D)).astype(np.float32))}, t=2)
    cfg = DepositumConfig(comm_period=3, fused="require")
    plan = MixPlan.dense(_w(), device="cpu")
    a, _ = step(st, {}, grad_fn, cfg, plan)
    b, _ = step(st, {}, grad_fn, cfg, MixSchedule.constant(plan))
    assert torch.equal(a.x["w"], b.x["w"]) and torch.equal(a.y["w"],
                                                            b.y["w"])

    from repro_torch.core import CompressionSpec

    c, _ = step(st, {}, grad_fn, cfg, MixSchedule.constant(
        plan).with_compression(CompressionSpec.none(device="cpu")))
    assert torch.equal(a.x["w"], c.x["w"]) and torch.equal(a.y["w"],
                                                            c.y["w"])
    assert c.comm == ()


# ---------------------------------------------------------------------------
# A reduced Fig. 8 grid through both sweep engines
# ---------------------------------------------------------------------------

C8, D8, K8, T0, R8 = 6, 10, 3, 2, 2


def _fig8(pkg):
    Plan = JPlan if pkg == "j" else MixPlan
    Sched = jsch.MixSchedule if pkg == "j" else MixSchedule
    kw = {} if pkg == "j" else {"device": "cpu"}
    base = Plan.dense(_w("ring", C8), **kw)
    pts = [Sched.lazy(base, p, rounds=R8, seed=42) for p in (0.5, 1.0)]
    pts += [Sched.chebyshev(base, k) for k in (1, 2)]
    stack, dens = ((jsch.stack_schedules, jsch.as_stacked_schedule)
                   if pkg == "j" else
                   (stack_schedules, as_stacked_schedule))
    return stack([dens(s, R8, C8) for s in pts])


def test_reduced_fig8_grid_matches_reference():
    fused = "require"      # the reference's Pallas kernels, interpreted
    ds = make_classification(n_samples=180, n_features=D8, n_classes=K8,
                             n_clients=C8, theta=1.0, seed=0)
    rng = np.random.default_rng(7)
    draws = [ds.stacked_batches(rng, 8, T0) for _ in range(R8)]
    bx = np.stack([d[0] for d in draws])
    by = np.stack([d[1] for d in draws])
    xs = np.stack([ds.client_arrays(i)[0] for i in range(C8)])
    ys = np.stack([ds.client_arrays(i)[1] for i in range(C8)])
    cfg_kw = dict(alpha=0.05, beta=0.5, gamma=0.5, comm_period=T0,
                  prox_name="l1", prox_kwargs={"lam": 1e-3}, fused=fused)

    params0 = init_mlp(jax.random.PRNGKey(0), D8, K8, hidden=(8, 4))
    grad_one = jax.grad(functools.partial(j_ce, apply_mlp))
    xj, yj = jnp.asarray(xs), jnp.asarray(ys)
    j_fns = {"local_at": lambda x: jax.vmap(grad_one)(x, {"x": xj, "y": yj}),
             "global_at": lambda x: jax.vmap(lambda p: grad_one(
                 p, {"x": xj.reshape(-1, D8), "y": yj.reshape(-1)}))(x)}
    jcfg = JConfig(**cfg_kw)
    jf, jo = j_sweep_run(
        params0, lambda x, b: (jax.vmap(grad_one)(x, b), {}), jcfg,
        _fig8("j"), j_stack_hypers([jcfg.hyper()] * 4),
        {"x": jnp.asarray(bx), "y": jnp.asarray(by)}, n_clients=C8,
        metrics_fn=lambda s, h: j_metrics(s, j_fns, jcfg, hyper=h))

    model = MLP(D8, K8, (8, 4))
    t_fns = stationarity_grad_fns(model, torch.from_numpy(xs),
                                  torch.from_numpy(ys))
    tcfg = DepositumConfig(**cfg_kw)
    tf, to = sweep_run(
        params_from_numpy(jax.tree_util.tree_map(np.asarray, params0),
                          device="cpu"), client_grad_fn(model), tcfg,
        _fig8("t"), stack_hypers([tcfg.hyper()] * 4),
        {"x": torch.from_numpy(bx), "y": torch.from_numpy(by)},
        n_clients=C8,
        metrics_fn=lambda s, h: stationarity_metrics(s, t_fns, tcfg,
                                                     hyper=h))
    tn = state_to_numpy(tf)
    for f in ("x", "y", "nu", "g"):
        for a, b in zip(jax.tree_util.tree_leaves(tn[f]),
                        jax.tree_util.tree_leaves(getattr(jf, f))):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5,
                                       atol=1e-6, err_msg=f)
    for k in ("consensus_x", "stationarity"):
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                   rtol=1e-4, err_msg=k)
