"""Port parity: the sweep engine.

* The paper's grids through both engines: a Fig. 3 step-size grid (linear
  + l1, S = 5) and a reduced Fig. 6 topology grid (MLP hidden (8, 4),
  S = 4 stacked dense W), port ``sweep_run`` against the reference
  ``sweep_run`` (Pallas kernels in interpret mode with fused on), fused
  ``off`` and ``require``.  Final state at rtol 1e-5 / atol 1e-6, metric
  curves at rtol 1e-4 (as ``test_torch_slice.py``): the two sum gradients
  and mixes in another order.
* Port ``sweep_run`` against port ``sweep_run_sequential`` (the one-config
  round program per point) for the reference's ``test_sweep.py`` cases:
  zipped Hyper x topology, ``params_axis=0``, ``batch_axis=0``, an
  unstacked Hyper, ``make_sweep_round`` with a swapped plan, and the batch
  adapters, at the reference's rtol 2e-5 / atol 1e-6.
* The fused sweep makes one grouped call a step for all S configs
  (``lead=2``, an (S, 5) table), and every host-side error comes before a
  step runs.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import (apply_linear, apply_mlp, ce_loss as j_ce,
                               init_linear, init_mlp)
from repro.core import (DepositumConfig as JConfig, MixPlan as JPlan,
                        stack_hypers as j_stack_hypers,
                        stack_mixplans as j_stack_plans,
                        stationarity_metrics as j_metrics)
from repro.data import make_classification
from repro.training.sweep import sweep_run as j_sweep_run
from repro_torch.convert import params_from_numpy, state_to_numpy
from repro_torch.core import (DepositumConfig, Hyper, MixPlan, hyper_grid,
                              stack_hypers, stack_mixplans,
                              stationarity_metrics, step)
from repro_torch.core import depositum as tdep
from repro_torch.kernels.prox import ops
from repro_torch.models.classifier import (MLP, LinearClassifier,
                                           client_grad_fn,
                                           stationarity_grad_fns)
from repro_torch.quickstart import grid_wall_s
from repro_torch.training.sweep import (broadcast_batches, make_sweep_round,
                                        stack_rounds, sweep_batch_iter,
                                        sweep_init, sweep_run,
                                        sweep_run_fedalg,
                                        sweep_run_sequential)

C, D, K, T0, BATCH, N_SAMPLES, ROUNDS = 4, 12, 3, 3, 8, 240, 2
FIELDS = ("x", "y", "nu", "g")
STATE_TOL = dict(rtol=1e-5, atol=1e-6)
CURVE_RTOL = 1e-4
SEQ_TOL = dict(rtol=2e-5, atol=1e-6)
METRICS = ("prox_grad_sq", "consensus_x", "stationarity")
FIG3_GRID = [(0.05, 0.5), (0.05, 1.0), (0.1, 0.5), (0.1, 1.0), (0.2, 0.5)]
TOPOS = ["complete", "ring", "star", "torus"]


# ---------------------------------------------------------------------------
# The paper's grids against the reference sweep engine
# ---------------------------------------------------------------------------

def _grid(name):
    """(model kind, hidden, prox, config floats, per-point hypers / plans)."""
    if name == "fig3":
        cfg = dict(gamma=0.5, comm_period=T0, prox_name="l1",
                   prox_kwargs={"lam": 1e-3})
        points = [dict(alpha=a, beta=b) for a, b in FIG3_GRID]
        return "linear", None, cfg, points, ["ring"] * len(points)
    cfg = dict(alpha=0.05, beta=0.5, gamma=0.5, comm_period=T0,
               prox_name="mcp", prox_kwargs={"lam": 1e-3, "theta": 4.0})
    return "mlp", (8, 4), cfg, [{}] * len(TOPOS), TOPOS


@functools.lru_cache(maxsize=None)
def _data():
    ds = make_classification(n_samples=N_SAMPLES, n_features=D, n_classes=K,
                             n_clients=C, theta=1.0, seed=0)
    rng = np.random.default_rng(7)
    draws = [ds.stacked_batches(rng, BATCH, T0) for _ in range(ROUNDS)]
    xs = np.stack([ds.client_arrays(i)[0] for i in range(C)])
    ys = np.stack([ds.client_arrays(i)[1] for i in range(C)])
    return (xs, ys, np.stack([d[0] for d in draws]),
            np.stack([d[1] for d in draws]))


def _reference(name, fused):
    kind, hidden, cfg_kw, points, topos = _grid(name)
    xs, ys, bx, by = _data()
    if kind == "linear":
        params0 = init_linear(jax.random.PRNGKey(0), D, K)
        apply = apply_linear
    else:
        params0 = init_mlp(jax.random.PRNGKey(0), D, K, hidden=hidden)
        apply = apply_mlp
    grad_one = jax.grad(functools.partial(j_ce, apply))
    grad_fn = lambda x, b: (jax.vmap(grad_one)(x, b), {})
    xj, yj = jnp.asarray(xs), jnp.asarray(ys)
    all_x, all_y = xj.reshape(-1, D), yj.reshape(-1)
    grad_fns = {
        "local_at": lambda x: jax.vmap(grad_one)(x, {"x": xj, "y": yj}),
        "global_at": lambda x: jax.vmap(lambda p: grad_one(
            p, {"x": all_x, "y": all_y}))(x)}
    cfg = JConfig(fused=fused, **cfg_kw)
    hypers = j_stack_hypers([cfg.hyper()._replace(
        **{k: jnp.asarray(v, jnp.float32) for k, v in pt.items()})
        for pt in points])
    plans = [JPlan.from_topology(t, C) for t in topos]
    plan = plans[0] if len(set(topos)) == 1 else j_stack_plans(plans)
    final, outs = j_sweep_run(
        params0, grad_fn, cfg, plan, hypers,
        {"x": jnp.asarray(bx), "y": jnp.asarray(by)}, n_clients=C,
        metrics_fn=lambda st, hp: j_metrics(st, grad_fns, cfg, hyper=hp))
    return params0, final, outs


def _port(name, fused, params_np):
    kind, hidden, cfg_kw, points, topos = _grid(name)
    xs, ys, bx, by = _data()
    model = LinearClassifier(D, K) if kind == "linear" else MLP(D, K, hidden)
    cfg = DepositumConfig(fused=fused, **cfg_kw)
    hypers = stack_hypers([cfg.hyper().replace(**pt) for pt in points])
    plans = [MixPlan.from_topology(t, C, device="cpu") for t in topos]
    plan = plans[0] if len(set(topos)) == 1 else stack_mixplans(plans)
    grad_fns = stationarity_grad_fns(model, torch.from_numpy(xs),
                                     torch.from_numpy(ys))
    return sweep_run(
        params_from_numpy(params_np, device="cpu"), client_grad_fn(model),
        cfg, plan, hypers,
        {"x": torch.from_numpy(bx), "y": torch.from_numpy(by)},
        n_clients=C,
        metrics_fn=lambda st, hp: stationarity_metrics(st, grad_fns, cfg,
                                                       hyper=hp))


@pytest.mark.parametrize("fused", ["off", "require"])
@pytest.mark.parametrize("grid", ["fig3", "fig6"])
def test_paper_grid_matches_reference_sweep(grid, fused):
    params0, j_final, j_outs = _reference(grid, fused)
    t_final, t_outs = _port(grid, fused,
                            jax.tree_util.tree_map(np.asarray, params0))
    tn = state_to_numpy(t_final)
    S = len(_grid(grid)[3])
    for f in FIELDS:
        jl = jax.tree_util.tree_leaves(getattr(j_final, f))
        tl = jax.tree_util.tree_leaves(tn[f])
        assert len(jl) == len(tl)
        for a, b in zip(tl, jl):
            assert a.shape[:2] == (S, C)
            np.testing.assert_allclose(a, np.asarray(b), err_msg=f,
                                       **STATE_TOL)
    for k in METRICS:
        assert tuple(t_outs[k].shape) == (S, ROUNDS)
        np.testing.assert_allclose(t_outs[k].numpy(), np.asarray(j_outs[k]),
                                   rtol=CURVE_RTOL, err_msg=k)


# ---------------------------------------------------------------------------
# Sweep against sequential, port only
# ---------------------------------------------------------------------------

N, DL, R = 6, 12, 3


@functools.lru_cache(maxsize=None)
def _lsq():
    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.standard_normal((N, 16, DL)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((N, 16)).astype(np.float32))
    return A, b


def lsq_grad_fn(x, batch):
    """Least-squares clients; the batch scales each client's gradient so
    per-point batches change the run."""
    A, b = _lsq()
    r = torch.einsum("nmd,nd->nm", A, x["w"]) - b
    g = torch.einsum("nmd,nm->nd", A, r) / A.shape[1]
    return {"w": g * batch["scale"][:, None]}, {}


def _cfg(**kw):
    base = dict(momentum="polyak", comm_period=T0, prox_name="mcp",
                prox_kwargs={"lam": 1e-3, "theta": 4.0})
    base.update(kw)
    return DepositumConfig(**base)


def _plans(topos):
    return stack_mixplans([MixPlan.from_topology(t, N, device="cpu")
                           for t in topos])


def _ones(*lead):
    return {"scale": torch.ones(lead + (R, T0, N))}


def _case(name):
    """(params0, mixer, hypers, batches, extra sweep_run kwargs)."""
    h = Hyper.create(alpha=0.05, beta=1.0, gamma=0.5, lam=1e-3)
    zeros = {"w": torch.zeros(DL)}
    rng = np.random.default_rng(3)
    if name == "zipped":
        hypers = stack_hypers([h.replace(alpha=a, gamma=g) for a, g in
                               ((0.05, 0.5), (0.1, 0.2), (0.02, 0.8))])
        return zeros, _plans(["complete", "ring", "star"]), hypers, \
            _ones(), {}
    if name == "params_axis":
        inits = torch.from_numpy(
            rng.standard_normal((3, DL)).astype(np.float32) * 0.1)
        return {"w": inits}, MixPlan.from_topology("ring", N, device="cpu"), \
            h, _ones(), {"params_axis": 0}
    if name == "batch_axis":
        scale = torch.from_numpy(
            rng.uniform(0.5, 1.5, (3, R, T0, N)).astype(np.float32))
        return zeros, MixPlan.from_topology("ring", N, device="cpu"), h, \
            {"scale": scale}, {"batch_axis": 0}
    # an unstacked Hyper broadcast over a stacked plan
    return zeros, _plans(["ring", "star", "torus"]), h, _ones(), {}


@pytest.mark.parametrize("fused", ["off", "require"])
@pytest.mark.parametrize("case", ["zipped", "params_axis", "batch_axis",
                                  "unstacked_hyper"])
def test_sweep_matches_sequential(case, fused):
    params0, mixer, hypers, batches, kw = _case(case)
    cfg = _cfg(fused=fused)
    fs, _ = sweep_run(params0, lsq_grad_fn, cfg, mixer, hypers, batches,
                      n_clients=N, **kw)
    fq, _ = sweep_run_sequential(params0, lsq_grad_fn, cfg, mixer, hypers,
                                 batches, n_clients=N, **kw)
    for f in FIELDS:
        a, b = getattr(fs, f)["w"], getattr(fq, f)["w"]
        assert tuple(a.shape) == (3, N, DL)
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=f,
                                   **SEQ_TOL)
    assert fs.t == fq.t == R * T0
    # the points really differ (the sweep axis is not collapsed)
    assert float((fs.x["w"][0] - fs.x["w"][1]).abs().max()) > 1e-6


def test_make_sweep_round_swaps_plan_and_broadcasts_hyper():
    """The plan is an operand of each call; a scalar Hyper broadcasts."""
    cfg = _cfg(fused="require")
    h = Hyper.create(alpha=0.05, beta=1.0, gamma=0.5, lam=1e-3)
    hypers = stack_hypers([h, h])
    plans_a, plans_b = _plans(["ring", "star"]), _plans(["complete",
                                                         "torus"])
    states = sweep_init({"w": torch.zeros(DL)}, N, 2)
    b = broadcast_batches({"scale": torch.ones(T0, N)}, 2)
    round_fn = make_sweep_round(lsq_grad_fn, cfg, plans_a, batch_axis=0)
    s_a, _ = round_fn(states, hypers, b)
    s_b, _ = round_fn(states, hypers, b, plan=plans_b)
    direct, _ = make_sweep_round(lsq_grad_fn, cfg, plans_b,
                                 batch_axis=0)(states, hypers, b)
    assert float((s_a.x["w"] - s_b.x["w"]).abs().max()) > 1e-6
    assert torch.equal(s_b.x["w"], direct.x["w"])
    s_scalar, _ = round_fn(states, h, b)
    assert torch.equal(s_scalar.x["w"], s_a.x["w"])
    # one round of the sweep == one sequential round of each point
    fq, _ = sweep_run_sequential({"w": torch.zeros(DL)}, lsq_grad_fn, cfg,
                                 plans_a, hypers,
                                 {"scale": torch.ones(1, T0, N)},
                                 n_clients=N)
    np.testing.assert_allclose(s_a.x["w"].numpy(), fq.x["w"].numpy(),
                               **SEQ_TOL)


def test_batch_adapters():
    base = {"x": torch.arange(6.0).reshape(T0, 2), "y": torch.ones(T0)}
    b = broadcast_batches(base, 4)
    assert tuple(b["x"].shape) == (4, T0, 2) and b["x"].stride(0) == 0
    assert b["x"].data_ptr() == base["x"].data_ptr()       # a view
    it = list(sweep_batch_iter(iter([base, base]), 3))
    assert len(it) == 2 and tuple(it[1]["y"].shape) == (3, T0)
    rounds = stack_rounds([base] * 5)
    assert tuple(rounds["x"].shape) == (5, T0, 2)
    assert tuple(stack_rounds([torch.zeros(T0, 1)] * 2).shape) == (2, T0, 1)
    st = sweep_init({"w": torch.ones(DL)}, N, 3)
    assert tuple(st.x["w"].shape) == (3, N, DL) and st.t == 0
    assert float(st.y["w"].abs().sum()) == 0.0


def test_fused_sweep_is_one_grouped_call_a_step(monkeypatch):
    """sweep_run: one lead=2 call of each grouped wrapper a step with the
    (S, 5) table; the sequential path one lead=1 call a point and step."""
    calls = []

    def spy(name, fn):
        def wrapped(*args, lead=2, **kw):
            calls.append((name, lead, tuple(args[3].shape)))
            return fn(*args, lead=lead, **kw)
        return wrapped

    monkeypatch.setattr(ops, "fused_update_sweep_grouped",
                        spy("update", ops.fused_update_sweep_grouped))
    monkeypatch.setattr(ops, "fused_tracking_sweep_grouped",
                        spy("tracking", ops.fused_tracking_sweep_grouped))
    params0, mixer, hypers, batches, _ = _case("zipped")
    cfg = _cfg(fused="require")
    sweep_run(params0, lsq_grad_fn, cfg, mixer, hypers, batches, n_clients=N)
    steps = R * T0
    assert calls == [(n, 2, (3, 5)) for _ in range(steps)
                     for n in ("update", "tracking")]
    calls.clear()
    sweep_run_sequential(params0, lsq_grad_fn, cfg, mixer, hypers, batches,
                         n_clients=N)
    assert calls == [(n, 1, (1, 5)) for _ in range(3 * steps)
                     for n in ("update", "tracking")]


@pytest.mark.parametrize("error", ["zip", "gamma", "alpha_rho", "nesterov",
                                   "opt_out", "int_params"])
def test_host_side_errors_come_before_any_step(error):
    seen = []

    def grad_fn(x, batch):
        seen.append(1)
        return lsq_grad_fn(x, batch)

    params0, mixer, hypers, batches, _ = _case("zipped")
    cfg, backend = _cfg(fused="require"), None
    match = "fused='require'"
    if error == "zip":
        hypers, match = stack_hypers([Hyper.create()] * 2), "disagrees"
    elif error == "gamma":
        hypers, match = hyper_grid(base=cfg.hyper(), gamma=[0.5, 1.0, 0.2]), \
            "gamma"
    elif error == "alpha_rho":
        hypers, match = hyper_grid(base=cfg.hyper(), alpha=[0.05, 5.0, 0.1]), \
            "alpha\\*rho"
    elif error == "nesterov":
        cfg = _cfg(fused="require", momentum="nesterov")
    elif error == "opt_out":
        class NoFused:
            name, supports_fused_sweep = "no-fused", False

            def mixer_for(self, plan, *, sweep=False):
                raise AssertionError("not reached")
        backend, match = NoFused(), "opts out"
    else:
        params0 = {"w": torch.zeros(DL, dtype=torch.int32)}
    for run in (sweep_run, sweep_run_sequential):
        with pytest.raises(ValueError, match=match):
            run(params0, grad_fn, cfg, mixer, hypers, batches, n_clients=N,
                backend=backend)
    assert seen == []


def test_later_slices_raise_naming_their_queue_item():
    """Baselines, telemetry and the distributed backends have landed: the
    sweep takes a recorder and ``sweep_run_fedalg`` runs (both held
    against the reference in ``test_torch_obs.py`` /
    ``test_torch_fedopt.py``); the wire path decides as the reference's,
    and a sweep through a one-process ``ShardMapBackend`` is the stacked
    sweep bit for bit (the gloo runs: ``test_torch_distributed.py``)."""
    from repro_torch.core.fedopt import FedAlgConfig, make_algorithm
    from repro_torch.obs.record import Telemetry

    params0, mixer, hypers, batches, _ = _case("zipped")
    tel = Telemetry.memory()
    sweep_run(params0, lsq_grad_fn, _cfg(), mixer, hypers, batches,
              n_clients=N, telemetry=tel)
    assert tel.memory_sink.configs() == [0, 1, 2]
    final, _ = sweep_run_fedalg(
        make_algorithm("fedmid", FedAlgConfig(local_steps=T0)), params0,
        lsq_grad_fn, hypers, batches, n_clients=N)
    assert final.t == R and final.x["w"].shape == (3, N, DL)
    from repro_torch.core import CompressionSpec, as_schedule
    from repro_torch.core.schedule import wire_supported
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training.backends import get_backend
    assert wire_supported(as_schedule(MixPlan.from_topology(
        "ring", N, device="cpu")).with_compression(
            CompressionSpec.qsgd(4, device="cpu")))
    be = get_backend("shard_map", mesh=make_host_mesh(1, 1),
                     axis_name="data", n_clients=N)
    got, _ = sweep_run(params0, lsq_grad_fn, _cfg(), mixer, hypers, batches,
                       n_clients=N, backend=be)
    want, _ = sweep_run(params0, lsq_grad_fn, _cfg(), mixer, hypers,
                        batches, n_clients=N)
    for f in ("x", "y", "nu", "g"):
        for k in getattr(want, f):
            assert torch.equal(getattr(got, f)[k], getattr(want, f)[k])


def test_one_config_step_refuses_a_stacked_hyper():
    cfg = _cfg(fused="require")
    st = tdep.init({"w": torch.zeros(DL)}, N, device="cpu")
    grid = hyper_grid(base=cfg.hyper(), alpha=[0.05, 0.1])
    with pytest.raises(ValueError, match="stacked Hyper"):
        step(st, {"scale": torch.ones(N)}, lsq_grad_fn, cfg,
             MixPlan.from_topology("ring", N, device="cpu"), hyper=grid)
    assert not tdep.fused_eligibility(cfg, st, grid)[0]
    assert tdep.fused_eligibility(cfg, st, grid, sweep=True)[0]


def test_fig3_grid_rows_match_sequential_rows():
    """``run_depositum_grid`` (one sweep) against ``run_depositum`` per
    config, through the figures module, one round on the CPU."""
    from repro_torch.figures import fig3_run
    grid = fig3_run(rounds=1, device="cpu", fused="require")
    seq = fig3_run(rounds=1, sequential=True, device="cpu", fused="require")
    assert {r["sweep_group_id"] for r in grid} == {0}
    assert grid_wall_s(grid) == grid[0]["sweep_group_wall_s"]
    for g, s in zip(grid, seq):
        for k in ("final_loss", "final_prox_grad", "final_consensus_x"):
            np.testing.assert_allclose(g[k], s[k], rtol=CURVE_RTOL, err_msg=k)
