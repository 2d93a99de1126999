"""Port parity: compressed gossip through the DEPOSITUM round and the sweep.

Least squares (n clients, d unknowns, A and b from a numpy seed) on a ring,
in both packages, with the reference's threefry uniforms injected into the
port's specs (``test_torch_compression.ref_draws``).  Tolerances:

* one compressed comm step from the same random state (memory included):
  rtol 1e-6 / atol 1e-7 — the mix's products sum in another order,
  everything else is the same fp32 elementwise arithmetic — except where
  the fresh gradients enter (g, y and y's memory): their products sum in
  another order too, so atol there is one ulp of max|g| (~1e-6 here);
* whole runs (n 8, d 16, 5 rounds, T0 2; top-k 0.25 and QSGD 4 bits):
  rtol 1e-5 / atol 1e-6, the reference's ``test_compression.py`` bound
  for its own pointwise-vs-grid runs;
* the reduced frontier (``fig_comm_frontier.py`` on its quick grid, 5
  rounds) against the reference's ``run``: loss and consensus curves
  within 1e-4 relative, bytes exactly;
* the port against itself: a ``none`` spec and no spec, fused and unfused,
  frozen cohort rows and their memory — bit for bit; a stacked mixed grid
  against its pointwise runs at rtol 1e-5 / atol 1e-6 (batched against
  single products).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import fig_comm_frontier as fcf
from repro.core import depositum as jdep
from repro.core import compression as jc
from repro.core import schedule as jsch
from repro.core.mixing import MixPlan as JPlan
from repro.training.sweep import sweep_run as j_sweep_run
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import (CohortSampler, CompressionSpec, DepositumConfig,
                              MixPlan, MixSchedule, as_mixed, as_schedule,
                              init,
                              local_then_comm_round, pad_plan, stack_hypers,
                              stack_schedules, step)
from repro_torch.figures import comm_run
from repro_torch.training.sweep import (make_sweep_round, sweep_init,
                                        sweep_run, sweep_run_sequential)
from tests.test_torch_compression import ref_draws

N, DL, M, T0, ROUNDS = 8, 16, 8, 2, 5
STEP_TOL = dict(rtol=1e-6, atol=1e-7)
RUN_TOL = dict(rtol=1e-5, atol=1e-6)
FIELDS = ("x", "y", "nu", "g")
CPU = dict(device="cpu")


def _lsq(seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N, M, DL)).astype(np.float32)
    b = np.einsum("nmd,d->nm", A, rng.standard_normal(DL).astype(
        np.float32))
    return A, b


def _grad_fns(A, b):
    jA, jb = jnp.asarray(A), jnp.asarray(b)
    tA, tb = torch.from_numpy(A), torch.from_numpy(b)
    n = A.shape[0]

    def j_grad(x, batch):
        r = jnp.einsum("nmd,nd->nm", jA, x["w"]) - jb
        return {"w": jnp.einsum("nmd,nm->nd", jA, r) / M}, {}

    def t_grad(x, batch):
        w = x["w"]
        r = torch.einsum("nmd,nd->nm", tA, w[:n]) - tb
        g = torch.einsum("nmd,nm->nd", tA, r) / M
        if w.shape[0] > n:                       # padding rows: no gradient
            g = torch.cat([g, g.new_zeros((w.shape[0] - n,) + g.shape[1:])])
        return {"w": g}, {}

    return j_grad, t_grad


def _cfg(fused="off", T=T0):
    return dict(alpha=0.05, beta=0.5, gamma=0.5, comm_period=T,
                prox_name="l1", prox_kwargs={"lam": 1e-4}), fused


def _configs(fused="off"):
    kw, fused = _cfg(fused)
    return jdep.DepositumConfig(**kw), DepositumConfig(**kw, fused=fused)


def _spec_pair(kind):
    if kind == "topk":
        return jc.CompressionSpec.topk(0.25), CompressionSpec.topk(0.25,
                                                                   **CPU)
    if kind == "randk":
        j = jc.CompressionSpec.randk(0.5, seed=4)
        t = CompressionSpec.randk(0.5, seed=4, **CPU)
    elif kind == "qsgd":
        j = jc.CompressionSpec.qsgd(4, seed=2)
        t = CompressionSpec.qsgd(4, seed=2, **CPU)
    else:                                       # a mixed point (qsgd)
        j = jc.as_mixed(jc.CompressionSpec.qsgd(3, seed=6))
        t = as_mixed(CompressionSpec.qsgd(3, seed=6, **CPU))
    return j, dataclasses.replace(t, uniforms=ref_draws(j.key))


def _scheds(js, ts):
    W = np.asarray(MixPlan.from_topology("ring", N, **CPU).W)
    return (jsch.as_schedule(JPlan.dense(W)).with_compression(js),
            as_schedule(MixPlan.dense(W, **CPU)).with_compression(ts))


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=what, **tol)


@pytest.mark.parametrize("fused", ["off", "require"])
@pytest.mark.parametrize("kind", ["topk", "randk", "qsgd", "mixed"])
def test_one_compressed_comm_step_matches_reference(kind, fused):
    """A comm step (t = 3, T0 = 2: round 1) from a random state with
    nonzero memory; x, y, nu, g, xhat and s at STEP_TOL (the port fused or
    not, the reference unfused)."""
    A, b = _lsq(1)
    j_grad, t_grad = _grad_fns(A, b)
    js, ts = _spec_pair(kind)
    jsched, tsched = _scheds(js, ts)
    jcfg, tcfg = _configs(fused)
    rng = np.random.default_rng(2)
    rand = lambda: {"w": (rng.standard_normal((N, DL)) * 0.3).astype(
        np.float32)}
    st = {"x": rand(), "y": rand(), "nu": rand(),
          "mu": {"w": np.zeros((N, DL), np.float32)}, "g": rand(), "t": 3,
          "comm": {v: {"xhat": rand(), "s": rand()} for v in ("x", "y")}}
    jst = jdep.DepositumState(
        *({"w": jnp.asarray(st[f]["w"])} for f in ("x", "y", "nu", "mu",
                                                   "g")),
        t=jnp.asarray(3, jnp.int32),
        comm={v: jc.CommMemory(xhat={"w": jnp.asarray(m["xhat"]["w"])},
                               s={"w": jnp.asarray(m["s"]["w"])})
              for v, m in st["comm"].items()})
    jout, _ = jdep.step(jst, None, j_grad, jcfg, jsched)
    tout, _ = step(state_from_numpy(st, **CPU), None, t_grad, tcfg, tsched)
    assert tout.t == 4
    # the fresh gradients' products sum in another order: g, and y and its
    # memory through y + beta (g - g_old), carry up to an ulp of max|g|
    g_tol = dict(rtol=STEP_TOL["rtol"], atol=float(np.spacing(
        np.abs(np.asarray(jout.g["w"])).max())))
    for f in FIELDS:
        _close(getattr(tout, f)["w"], getattr(jout, f)["w"],
               g_tol if f in ("y", "g") else STEP_TOL, f)
    for v in ("x", "y"):
        for f in ("xhat", "s"):
            _close(getattr(tout.comm[v], f)["w"],
                   getattr(jout.comm[v], f)["w"],
                   g_tol if v == "y" else STEP_TOL, f"{v}.{f}")


@pytest.mark.parametrize("path", ["round", "sweep"])
@pytest.mark.parametrize("kind", ["topk", "qsgd"])
def test_compressed_runs_match_reference(kind, path):
    """n 8, d 16, 5 rounds of T0 2 with top-k 0.25 / QSGD 4 bits: the
    reference's ``sweep_run`` against the port's round loop and its
    ``sweep_run``, state and memory at RUN_TOL."""
    A, b = _lsq(0)
    j_grad, t_grad = _grad_fns(A, b)
    js, ts = _spec_pair(kind)
    jsched, tsched = _scheds(js, ts)
    jcfg, tcfg = _configs()
    ref, _ = j_sweep_run({"w": jnp.zeros(DL)}, j_grad, jcfg, jsched,
                         jcfg.hyper(), jnp.zeros((ROUNDS, T0, 1)),
                         n_clients=N)
    ref = jax.tree_util.tree_map(
        lambda v: np.asarray(v).reshape(N, DL) if np.size(v) > 1 else v, ref)
    params0 = {"w": torch.zeros(DL)}
    batches = torch.zeros((ROUNDS, T0, 1))
    if path == "round":
        st = init(params0, N, compress=tsched, **CPU)
        for r in range(ROUNDS):
            st, _ = local_then_comm_round(st, batches[r], t_grad, tcfg,
                                          tsched)
        point = lambda v: v
    else:
        st, _ = sweep_run(params0, t_grad, tcfg, tsched, tcfg.hyper(),
                          batches, n_clients=N)
        point = lambda v: v[0]
    assert st.t == ROUNDS * T0
    for f in FIELDS:
        _close(point(getattr(st, f)["w"]), getattr(ref, f)["w"], RUN_TOL, f)
    for v in ("x", "y"):
        for f in ("xhat", "s"):
            _close(point(getattr(st.comm[v], f)["w"]),
                   getattr(ref.comm[v], f)["w"], RUN_TOL, f"{v}.{f}")


@pytest.mark.parametrize("fused", ["off", "require"])
def test_none_spec_is_bit_equal_to_no_spec(fused):
    A, b = _lsq(3)
    _, t_grad = _grad_fns(A, b)
    cfg = DepositumConfig(**_cfg(T=1)[0], fused=fused)
    plain = as_schedule(MixPlan.from_topology("ring", N, **CPU))
    none = plain.with_compression(CompressionSpec.none(**CPU))
    rng = np.random.default_rng(4)
    params0 = {"w": torch.from_numpy(rng.standard_normal(DL).astype(
        np.float32))}
    a = init(params0, N, **CPU)
    bb = init(params0, N, compress=CompressionSpec.none(**CPU), **CPU)
    assert bb.comm == () and init(params0, N, compress=none, **CPU).comm == ()
    for _ in range(5):
        a, _ = step(a, None, t_grad, cfg, plain)
        bb, _ = step(bb, None, t_grad, cfg, none)
    for f in FIELDS:
        assert torch.equal(getattr(a, f)["w"], getattr(bb, f)["w"])
    assert bb.comm == ()


def test_compressed_schedule_needs_memory():
    A, b = _lsq(3)
    _, t_grad = _grad_fns(A, b)
    _, cfg = _configs()
    sched = as_schedule(MixPlan.from_topology("ring", N, **CPU)) \
        .with_compression(CompressionSpec.topk(0.5, **CPU))
    st = init({"w": torch.zeros(DL)}, N, **CPU)
    with pytest.raises(ValueError, match="error-feedback memory"):
        local_then_comm_round(st, torch.zeros((T0, 1)), t_grad, cfg, sched)


@pytest.mark.parametrize("kind", ["topk", "qsgd"])
def test_cohort_round_freezes_memory_of_frozen_rows(kind):
    """A compressed cohort schedule (6 clients padded to 8, Bernoulli 0.5):
    after every round, each row the round's mask left out — every padding
    row too — keeps its state and its memory bit for bit; fused = unfused
    bit for bit; active rows' memory moves."""
    A, b = _lsq(5)
    A, b = A[:6], b[:6]
    _, t_grad = _grad_fns(A, b)
    spec = (CompressionSpec.topk(0.25, **CPU) if kind == "topk"
            else CompressionSpec.qsgd(4, seed=9, **CPU))
    ring = MixPlan.from_topology("ring", 6, **CPU)
    sched = MixSchedule.cohort(pad_plan(ring, 8), CohortSampler.bernoulli(
        0.5, 8, seed=3, n_eff=6, **CPU)).with_compression(spec)
    params0 = {"w": torch.ones(DL) * 0.1}
    finals, moved = {}, 0
    for fused in ("off", "require"):
        _, cfg = _configs(fused)
        st = init(params0, 6, n_max=8, compress=spec, **CPU)
        for r in range(4):
            before = st
            st, _ = local_then_comm_round(st, torch.zeros((T0, 1)), t_grad,
                                          cfg, sched)
            idle = sched.sampler.mask_at(r) <= 0
            assert bool(idle[6:].all())
            trees = [(getattr(st, f), getattr(before, f)) for f in FIELDS]
            trees += [(getattr(st.comm[v], f), getattr(before.comm[v], f))
                      for v in ("x", "y") for f in ("xhat", "s")]
            for new, old in trees:
                assert torch.equal(new["w"][idle], old["w"][idle])
            moved += int((st.comm["x"].xhat["w"][~idle]
                          != before.comm["x"].xhat["w"][~idle]).any())
            for new, _ in trees[-4:]:
                assert not new["w"][6:].any()
        finals[fused] = st
    assert moved >= 4
    a, bb = finals["off"], finals["require"]
    for f in FIELDS:
        assert torch.equal(getattr(a, f)["w"], getattr(bb, f)["w"])
    for v in ("x", "y"):
        for f in ("xhat", "s"):
            assert torch.equal(getattr(a.comm[v], f)["w"],
                               getattr(bb.comm[v], f)["w"])


def _grid():
    base = as_schedule(MixPlan.from_topology("ring", N, **CPU))
    specs = [CompressionSpec.none(**CPU), CompressionSpec.topk(0.25, **CPU),
             CompressionSpec.randk(0.5, seed=1, **CPU),
             CompressionSpec.qsgd(4, seed=2, **CPU)]
    return stack_schedules([base.with_compression(s) for s in specs])


def test_stacked_mixed_grid_matches_pointwise_runs():
    """A mixed grid (none / top-k / rand-k / QSGD, the port's hashed draws)
    as one sweep: fused = unfused bit for bit, ``make_sweep_round`` from
    ``sweep_init(compress=grid)`` = ``sweep_run`` bit for bit, and every
    point against its pointwise run at RUN_TOL; every point carries memory,
    the mixed ``none`` point included."""
    A, b = _lsq(6)
    _, t_grad = _grad_fns(A, b)
    grid = _grid()
    assert grid.compress.kind == "mixed"
    params0 = {"w": torch.zeros(DL)}
    batches = torch.zeros((ROUNDS, T0, 1))
    runs = {}
    for fused in ("off", "require"):
        _, cfg = _configs(fused)
        hypers = stack_hypers([cfg.hyper()] * 4)
        runs[fused] = sweep_run(params0, t_grad, cfg, grid, hypers, batches,
                                n_clients=N)[0]
    _, cfg = _configs()
    seq = sweep_run_sequential(params0, t_grad, cfg, grid, cfg.hyper(),
                               batches, n_clients=N)[0]
    states = sweep_init(params0, N, 4, compress=grid)
    round_fn = make_sweep_round(t_grad, cfg, grid, batch_axis=None)
    for r in range(ROUNDS):
        states, _ = round_fn(states, cfg.hyper(), batches[r])
    sw = runs["off"]
    leaves = lambda st: [getattr(st, f)["w"] for f in FIELDS] + [
        getattr(st.comm[v], f)["w"] for v in ("x", "y")
        for f in ("xhat", "s")]
    for a, f, h, q in zip(leaves(sw), leaves(runs["require"]),
                          leaves(states), leaves(seq)):
        assert torch.equal(a, f) and torch.equal(a, h)
        np.testing.assert_allclose(a.numpy(), q.numpy(), **RUN_TOL)
    assert all(bool(sw.comm["x"].xhat["w"][s].any()) for s in range(4))


def test_reduced_frontier_matches_reference(monkeypatch):
    """``fig_comm_frontier.py``'s quick grid (dense, top-k 0.1 / 0.5, QSGD
    4 bits), 5 rounds, as one sweep in both packages on the reference's A,
    b and draws: loss and consensus curves within 1e-4 relative, bytes and
    bits a coordinate exactly; the port's sequential native runs agree."""
    monkeypatch.setattr(fcf, "TOPK_RATES", [0.1, 0.5])
    monkeypatch.setattr(fcf, "QSGD_BITS", [4])
    ref = fcf.run(rounds=5)
    A, b = (np.asarray(v) for v in fcf._data())
    kw = dict(device="cpu", rates=[0.1, 0.5], bits=[4], data=(A, b),
              uniforms=ref_draws(jax.random.PRNGKey(0)))
    rows = comm_run(5, **kw)
    seq = comm_run(5, sequential=True, **kw)
    assert [r["name"] for r in rows] == [r["name"] for r in ref]
    for got, alone, want in zip(rows, seq, ref):
        for k in ("bytes_per_round", "bits_per_coord", "total_mb"):
            assert got[k] == want[k], (got["name"], k)
        for k in ("loss", "consensus_x"):
            np.testing.assert_allclose(got["curves"][k], want["curves"][k],
                                       rtol=1e-4, err_msg=got["name"])
            np.testing.assert_allclose(alone["curves"][k],
                                       got["curves"][k], rtol=1e-4)
    assert fcf.check(ref)["stacked_accounting_matches_native"]


def test_convert_round_trips_a_state_with_memory():
    A, b = _lsq(7)
    j_grad, t_grad = _grad_fns(A, b)
    js, ts = _spec_pair("qsgd")
    jsched, tsched = _scheds(js, ts)
    jcfg, tcfg = _configs()
    st = init({"w": torch.ones(DL)}, N, compress=tsched, **CPU)
    st, _ = local_then_comm_round(st, torch.zeros((T0, 1)), t_grad, tcfg,
                                  tsched)
    back = state_from_numpy(state_to_numpy(st), **CPU)
    assert back.t == st.t
    for v in ("x", "y"):
        for f in ("xhat", "s"):
            assert torch.equal(getattr(back.comm[v], f)["w"],
                               getattr(st.comm[v], f)["w"])
    assert state_to_numpy(init({"w": torch.ones(DL)}, N, **CPU))["comm"] == ()
    # a reference state (CommMemory of jax arrays) converts too
    jst = jdep.init({"w": jnp.ones(DL)}, N, compress=js)
    jst, _ = jdep.local_then_comm_round(jst, jnp.zeros((T0, 1)), j_grad,
                                        jcfg, jsched)
    conv = state_from_numpy(jax.tree_util.tree_map(np.asarray, jst), **CPU)
    for v in ("x", "y"):
        for f in ("xhat", "s"):
            _close(getattr(conv.comm[v], f)["w"],
                   getattr(jst.comm[v], f)["w"], dict(rtol=0, atol=0), f)
