"""Port parity: the fedopt baselines, ``sweep_run_fedalg``, Table III and
Figs. 5 and 7.

* Each of FedMiD, FedDR, FedADMM and DSGD for 3 rounds of a small MLP
  (12 -> 8 -> 4 -> 3, 4 clients, T0 3, fp32) against ``repro.core.fedopt``
  from the reference's weights (``repro_torch.convert``), with the
  config's floats and with a ``hyper=`` override: every state tree within
  relative L2 ``REL`` = 1e-5 (the same fp32 operations; matmuls and means
  sum in another order).  DSGD also under a lazy ``MixSchedule`` (the
  reference's numpy masks) and, through ``sweep_run_fedalg``, a stacked
  ``plan=`` (ring and star as S = 2).  The raises mirror the reference's.
* ``test_baseline_decreases_objective``: the reference's sanity test,
  ported (each algorithm cuts the composite objective by 10% in 15
  rounds).
* ``sweep_run_fedalg`` on a reduced Table III cell (2 rounds, the three
  seeds as S = 3) against the reference's ``sweep_run_fedalg``: ``REL``;
  and against per-seed runs through the one-config round (``REL``).
* The reduced Table III (Dir(0.1), 2 rounds), Fig. 5 (T0 1 and 2, 4
  iterations) and Fig. 7 (n 4 and 9, T 20) rows against the reference
  benchmarks' ``run`` from the same weights: losses and consensus within
  rtol 1e-4 (as the other figure tests), accuracies within two samples of
  the test split.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import fig5_period as jf5
from benchmarks import fig7_speedup as jf7
from benchmarks import table3_algorithms as jt3
from benchmarks.common import apply_mlp, ce_loss as j_ce, init_mlp
from repro.core import Hyper as JHyper
from repro.core import MixPlan as JPlan
from repro.core import MixSchedule as JSched
from repro.core import stack_hypers as j_stack_hypers
from repro.core import stack_mixplans as j_stack_plans
from repro.core.fedopt import FedAlgConfig as JFedCfg
from repro.core.fedopt import make_algorithm as j_make
from repro.core.topology import mixing_matrix
from repro.data import make_classification
from repro.training.sweep import sweep_run_fedalg as j_sweep_fedalg
from repro_torch import figures
from repro_torch.convert import (fed_state_from_numpy, fed_state_to_numpy,
                                 params_from_numpy)
from repro_torch.core import (Hyper, MixPlan, MixSchedule, stack_hypers,
                              stack_mixplans)
from repro_torch.core.fedopt import ALGORITHMS, FedAlgConfig, make_algorithm
from repro_torch.core.prox import get_prox
from repro_torch.models.classifier import MLP, client_grad_fn
from repro_torch.training.sweep import sweep_run_fedalg

C, D, K, HIDDEN, T0, BATCH, N_SAMPLES, ROUNDS = 4, 12, 3, (8, 4), 3, 8, 240, 3
REL = 1e-5
CPU = dict(device="cpu")
FIELDS = ("x", "aux1", "aux2")
# accuracies are argmaxes over the 1,024 held-out samples: two may flip
ACC_ATOL = 2.0 / 1024


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _assert_trees_close(port: dict, ref: dict, rel=REL, what=""):
    for a, b in zip(jax.tree_util.tree_leaves(port),
                    jax.tree_util.tree_leaves(ref)):
        assert np.shape(a) == np.shape(b), what
        assert _rel(a, b) <= rel, (what, _rel(a, b))


def _assert_states_close(port_state, ref_state, rel=REL):
    got = fed_state_to_numpy(port_state)
    for f in FIELDS:
        _assert_trees_close(got[f], _np(getattr(ref_state, f)), rel, f)
    # a sweep's reference t is (S,): every point took the same rounds
    assert {int(got["t"])} == set(np.asarray(ref_state.t).reshape(-1).tolist())


@functools.lru_cache(maxsize=None)
def _data():
    ds = make_classification(n_samples=N_SAMPLES, n_features=D, n_classes=K,
                             n_clients=C, theta=1.0, seed=0)
    rng = np.random.default_rng(7)
    draws = [ds.stacked_batches(rng, BATCH, T0) for _ in range(ROUNDS)]
    return np.stack([d[0] for d in draws]), np.stack([d[1] for d in draws])


def _params_np():
    return _np(init_mlp(jax.random.PRNGKey(0), D, K, hidden=HIDDEN))


def _j_grad_fn():
    grad_one = jax.grad(functools.partial(j_ce, apply_mlp))
    return lambda x, b: (jax.vmap(grad_one)(x, b), {})


def _t_grad_fn():
    return client_grad_fn(MLP(D, K, HIDDEN))


def _fed_cfgs(**kw):
    kw.setdefault("prox_name", "scad")
    kw.setdefault("prox_kwargs", {"lam": 1e-3, "theta": 4.0})
    kw.setdefault("W", mixing_matrix("ring", C))
    common = dict(alpha=0.1, local_steps=T0, eta=0.5, **kw)
    return JFedCfg(**common), FedAlgConfig(**common)


def _run_both(alg, jcfg, tcfg, hyper=None, rounds=ROUNDS):
    bx, by = _data()
    ja, ta = j_make(alg, jcfg), make_algorithm(alg, tcfg)
    jgrad = _j_grad_fn()
    jh = None if hyper is None else JHyper.create(**hyper)
    th = None if hyper is None else Hyper.create(**hyper)
    jround = jax.jit(lambda st, b: ja.round(st, b, jgrad, hyper=jh))
    js = ja.init(init_mlp(jax.random.PRNGKey(0), D, K, hidden=HIDDEN), C)
    ts = ta.init(params_from_numpy(_params_np(), **CPU), C, **CPU)
    tgrad = _t_grad_fn()
    for r in range(rounds):
        js, _ = jround(js, {"x": jnp.asarray(bx[r]), "y": jnp.asarray(by[r])})
        ts, _ = ta.round(ts, {"x": torch.from_numpy(bx[r]),
                              "y": torch.from_numpy(by[r])}, tgrad, hyper=th)
    return js, ts


@pytest.mark.parametrize("hyper", [None, dict(alpha=0.07, lam=2e-3,
                                              theta=3.0)])
@pytest.mark.parametrize("alg", sorted(ALGORITHMS))
def test_algorithm_rounds_match_reference(alg, hyper):
    jcfg, tcfg = _fed_cfgs()
    js, ts = _run_both(alg, jcfg, tcfg, hyper)
    _assert_states_close(ts, js)
    # a reference state carried across is the port's to the bit
    back = fed_state_from_numpy(_np(js._asdict()), **CPU)
    for f in FIELDS:
        for a, b in zip(getattr(back, f).values(),
                        jax.tree_util.tree_leaves(getattr(js, f))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert back.t == ROUNDS


def test_dsgd_under_a_lazy_schedule_matches_reference():
    W = mixing_matrix("ring", C)
    jcfg, _ = _fed_cfgs(W=JSched.lazy(JPlan.dense(W), 0.5, rounds=ROUNDS,
                                      seed=3))
    _, tcfg = _fed_cfgs(W=MixSchedule.lazy(MixPlan.dense(W, **CPU), 0.5,
                                           rounds=ROUNDS, seed=3))
    js, ts = _run_both("dsgd", jcfg, tcfg)
    _assert_states_close(ts, js)


def test_dsgd_stacked_plan_sweep_matches_reference():
    """DSGD over ring and star as one ``sweep_run_fedalg`` (a stacked
    ``plan=``, a scalar Hyper broadcast over it)."""
    bx, by = _data()
    jcfg, tcfg = _fed_cfgs()
    topos = ("ring", "star")
    jplan = j_stack_plans([JPlan.from_topology(t, C) for t in topos])
    tplan = stack_mixplans([MixPlan.from_topology(t, C, **CPU)
                            for t in topos])
    hp = dict(alpha=0.1, lam=1e-3, theta=4.0)
    jf, _ = j_sweep_fedalg(
        j_make("dsgd", jcfg), init_mlp(jax.random.PRNGKey(0), D, K,
                                       hidden=HIDDEN), _j_grad_fn(),
        JHyper.create(**hp), {"x": jnp.asarray(bx), "y": jnp.asarray(by)},
        n_clients=C, plan=jplan)
    tf, _ = sweep_run_fedalg(
        make_algorithm("dsgd", tcfg), params_from_numpy(_params_np(), **CPU),
        _t_grad_fn(), Hyper.create(**hp),
        {"x": torch.from_numpy(bx), "y": torch.from_numpy(by)}, n_clients=C,
        plan=tplan)
    for f in FIELDS:
        for k, v in getattr(tf, f).items():
            assert v.shape[:2] == (2, C)
    _assert_states_close(tf, jf)
    # each point of the sweep is that topology's run alone
    for s, topo in enumerate(topos):
        jcfg_s, tcfg_s = _fed_cfgs(W=mixing_matrix(topo, C))
        _, alone = _run_both("dsgd", jcfg_s, tcfg_s)
        for k, v in alone.x.items():
            assert _rel(tf.x[k][s].numpy(), v.numpy()) <= REL


def test_raises_mirror_reference():
    _, tcfg = _fed_cfgs()
    with pytest.raises(KeyError, match="unknown algorithm"):
        make_algorithm("fedavg", tcfg)
    with pytest.raises(ValueError, match="DSGD needs a mixing matrix"):
        make_algorithm("dsgd", FedAlgConfig(W=None))
    bx, by = _data()
    batch = {"x": torch.from_numpy(bx[0]), "y": torch.from_numpy(by[0])}
    for alg in ("fedmid", "feddr", "fedadmm"):
        a = make_algorithm(alg, tcfg)
        st = a.init(params_from_numpy(_params_np(), **CPU), C, **CPU)
        with pytest.raises(ValueError, match="server mean"):
            a.round(st, batch, _t_grad_fn(),
                    plan=MixPlan.from_topology("ring", C, **CPU))
    a = make_algorithm("fedmid", tcfg)
    st = a.init(params_from_numpy(_params_np(), **CPU), C, **CPU)
    grid = stack_hypers([Hyper.create(alpha=0.1), Hyper.create(alpha=0.2)])
    with pytest.raises(ValueError, match="sweep axis"):
        a.round(st, batch, _t_grad_fn(), hyper=grid)
    with pytest.raises(ValueError, match="doubly stochastic|symmetric|rows"):
        sweep_run_fedalg(make_algorithm("dsgd", tcfg),
                         params_from_numpy(_params_np(), **CPU),
                         _t_grad_fn(), Hyper.create(),
                         {"x": torch.from_numpy(bx),
                          "y": torch.from_numpy(by)}, n_clients=C,
                         plan=MixPlan.dense(np.full((C, C), 0.3), **CPU))


# ---------------------------------------------------------------------------
# The reference's sanity test, ported
# ---------------------------------------------------------------------------

def _setup_problem(n_clients=6, d=32, n_classes=4):
    ds = make_classification(n_samples=1024, n_features=d,
                             n_classes=n_classes, n_clients=n_clients,
                             theta=1.0, seed=0)
    xs = torch.from_numpy(np.stack([ds.client_arrays(i)[0][:128]
                                    for i in range(n_clients)]))
    ys = torch.from_numpy(np.stack([ds.client_arrays(i)[1][:128]
                                    for i in range(n_clients)]))

    def per_client_loss(w, x, y):
        logits = x @ w
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, y[..., None].long())[..., 0]
        return torch.mean(logz - gold)

    grad_one = torch.func.vmap(torch.func.grad(per_client_loss))

    def grad_fn(x, batch):
        return {"w": grad_one(x["w"], *batch)}, {}

    prox = get_prox("l1", lam=1e-3)

    def objective(w):
        losses = torch.stack([per_client_loss(w, xs[i], ys[i])
                              for i in range(n_clients)])
        return float(torch.mean(losses) + prox.value({"w": w}))

    return {"w": torch.zeros(d, n_classes)}, (xs, ys), grad_fn, objective, \
        n_clients


@pytest.mark.parametrize("alg", sorted(ALGORITHMS))
def test_baseline_decreases_objective(alg):
    w0, batch, grad_fn, objective, n = _setup_problem()
    cfg = FedAlgConfig(alpha=0.1, local_steps=5, prox_name="l1",
                       prox_kwargs={"lam": 1e-3}, eta=0.5,
                       W=mixing_matrix("ring", n))
    a = make_algorithm(alg, cfg)
    state = a.init(w0, n, **CPU)
    # the same local batch T0 times (full-batch flavour)
    batches = tuple(v[None].expand((cfg.local_steps,) + v.shape)
                    for v in batch)
    before = objective(torch.mean(state.x["w"], 0))
    for _ in range(15):
        state, _ = a.round(state, batches, grad_fn)
    after = objective(torch.mean(state.x["w"], 0))
    assert after < before * 0.9, (alg, before, after)


# ---------------------------------------------------------------------------
# Table III, Fig. 5 and Fig. 7 against the reference benchmarks
# ---------------------------------------------------------------------------

def _t3_params(seed):
    return params_from_numpy(_np(init_mlp(jax.random.PRNGKey(seed),
                                          figures.T3_FEATURES,
                                          figures.T3_CLASSES)), **CPU)


@pytest.mark.parametrize("alg", ["depositum-I", "feddr"])
def test_table3_cell_matches_reference_sweep(alg, monkeypatch):
    """One reduced Table III cell (Dir(0.1), 2 rounds, seeds as S = 3)
    through ``sweep_run`` / ``sweep_run_fedalg`` in both packages, and the
    port's batched cell against its per-seed runs."""
    monkeypatch.setattr(jt3, "ROUNDS", 2)
    problems = [jt3._seed_problem(0.1, s) for s in jt3.SEEDS]
    params0 = jax.tree_util.tree_map(lambda *ps: jnp.stack(ps),
                                     *[p[1] for p in problems])
    batches = jax.tree_util.tree_map(lambda *bs: jnp.stack(bs),
                                     *[p[2] for p in problems])
    kw = dict(n_clients=jt3.N_CLIENTS, params_axis=0, batch_axis=0)
    if alg.startswith("depositum"):
        from repro.training.sweep import sweep_run as j_sweep_run
        dep = jt3._dep_config(alg)
        ref, _ = j_sweep_run(params0, jt3._grad_fn(), dep,
                             JPlan.from_topology("complete", jt3.N_CLIENTS),
                             j_stack_hypers([dep.hyper()] * 3), batches, **kw)
    else:
        cfg = JFedCfg(alpha=0.1, local_steps=jt3.T0, prox_name="scad",
                      prox_kwargs={"lam": 1e-4, "theta": 4.0}, eta=0.5,
                      W=mixing_matrix("complete", jt3.N_CLIENTS))
        ref, _ = j_sweep_fedalg(
            j_make(alg, cfg), params0, jt3._grad_fn(),
            j_stack_hypers([JHyper.create(alpha=0.1, lam=1e-4, theta=4.0)]
                           * 3), batches, **kw)
    got = figures.table3_cell(alg, 0.1, rounds=2, params0=_t3_params, **CPU)
    alone = figures.table3_cell(alg, 0.1, rounds=2, sequential=True,
                                params0=_t3_params, **CPU)
    ref_x = jax.tree_util.tree_leaves(_np(ref.x))
    for (k, v), want in zip(sorted(got["x"].items()), ref_x):
        assert v.shape == want.shape
        assert _rel(v.numpy(), want) <= REL, k
        assert _rel(v.numpy(), alone["x"][k].numpy()) <= REL, k
    np.testing.assert_allclose(got["accs"], alone["accs"], atol=ACC_ATOL)


def test_table3_rows_match_reference(monkeypatch):
    monkeypatch.setattr(jt3, "ROUNDS", 2)
    monkeypatch.setattr(jt3, "PARTITIONS", {"Dir(0.1)": 0.1})
    monkeypatch.setattr(figures, "T3_PARTITIONS", {"Dir(0.1)": 0.1})
    ref = jt3.run()
    rows = figures.table3_run(2, params0=_t3_params, **CPU)
    assert [r["partition"] for r in rows] == [r["partition"] for r in ref]
    for alg in figures.T3_ALGS:
        np.testing.assert_allclose(rows[0][f"_{alg}_mean"],
                                   ref[0][f"_{alg}_mean"], atol=ACC_ATOL,
                                   err_msg=alg)
        assert rows[0][f"_{alg}_wall_s"] > 0
    assert set(figures.table3_check(rows)) == set(jt3.check(ref))


def _fig_params():
    return params_from_numpy(_np(init_mlp(jax.random.PRNGKey(0), 123, 10)),
                             **CPU)


def _assert_rows_close(rows, ref, keys):
    assert len(rows) == len(ref)
    for got, want in zip(rows, ref):
        for k in keys:
            if k == "final_acc":
                np.testing.assert_allclose(got[k], want[k], atol=ACC_ATOL)
            else:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                           err_msg=k)


def test_fig5_rows_match_reference(monkeypatch):
    monkeypatch.setattr(jf5, "PERIODS", [1, 2])
    monkeypatch.setattr(jf5, "TOTAL_ITERS", 4)
    monkeypatch.setattr(figures, "FIG5_PERIODS", [1, 2])
    ref = jf5.run()
    rows = figures.fig5_run(4, params0=_fig_params(), **CPU)
    assert [r["T0"] for r in rows] == [1, 2]
    assert [r["communications"] for r in rows] == \
        [r["communications"] for r in ref]
    assert len({r["sweep_group_id"] for r in rows}) == 2  # a group a T0
    _assert_rows_close(rows, ref, ("final_loss", "final_acc",
                                   "final_consensus_x"))
    got, want = figures.fig5_check(rows), jf5.check(ref)
    assert set(got) == set(want)
    np.testing.assert_allclose(got["loss_spread"], want["loss_spread"],
                               rtol=1e-3, atol=1e-6)


def test_fig7_rows_match_reference(monkeypatch):
    monkeypatch.setattr(jf7, "CLIENTS", [4, 9])
    monkeypatch.setattr(jf7, "T", 20)
    monkeypatch.setattr(figures, "FIG7_CLIENTS", [4, 9])
    ref = jf7.run()
    rows = figures.fig7_run(20, params0=_fig_params(), **CPU)
    for got, want in zip(rows, ref):
        for k in ("n_clients", "alpha", "gamma", "batch"):
            assert got[k] == want[k], k
    _assert_rows_close(rows, ref, ("final_loss", "final_acc",
                                   "final_stationarity"))
    assert set(figures.fig7_check(rows)) == set(jf7.check(ref))


def test_figure_constants_are_published():
    """The tests above shrink the grids by patching these constants; the
    module keeps the published ones."""
    assert figures.FIG7_CLIENTS == [4, 9, 16, 25] == jf7.CLIENTS
    assert figures.FIG5_PERIODS == [1, 5, 10, 20] == jf5.PERIODS
    assert figures.FIG5_ITERS == figures.FIG7_ITERS == 400
    assert list(figures.T3_PARTITIONS) == list(jt3.PARTITIONS)
    assert figures.T3_ALGS == list(jt3.ALGS)
