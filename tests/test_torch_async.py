"""Port parity: the async runtime (``core/staleness.py``,
``training/async_runtime.py``) and the gated, donated masked round it
runs.

At the reference's sizes (``tests/test_async.py``: N 4, D 6, T0 2, B 3,
least squares on a ring, l1 1e-4, alpha 0.05), the port through its plain
kernel versions (``fused="auto"`` on the CPU) and the reference through its
own CPU path:

* straggler draws (every kind and fault knob over a grid of ``(client,
  work_round)``) are bit-equal to the reference's: both key
  ``numpy.random.default_rng`` by ``(seed, stream, client, work_round)``;
  the validation errors are the same; ``StalenessPolicy`` and the replay
  helpers agree exactly;
* ``AsyncTrainer.run``'s event log is ``==`` the reference's and its
  ``virtual_time`` equal, for the four delay laws with and without faults
  and for a downweight policy; final states within relative L2
  ``STATE_REL`` (the reference's own tau = 0 pin fails on this JAX, so the
  cross-package trajectories are held at a tolerance: the port's eager
  products and the reference's jitted ones round apart);
* the port's keystone: tau 0 with zero delay is ``torch.equal`` to its own
  synchronous ``FederatedTrainer`` on every tree (the all-ones lazy matrix
  is W bit for bit, and the gated kernels' live rows compute what the
  ungated ones do), fused and unfused;
* the reference suite's replay determinism, bounded staleness (a property
  test), downweight, faults, batch gathering, operand checks, history
  cadence and threaded mode (unmarked here: each threaded case has its own
  ``deadline_s`` of a few seconds and the port's eager round is fast), and
  ``tests/test_obs.py``'s two async cases;
* the donated masked round (the gate in the kernels on local and comm
  steps, the post-mix keep from the pre-mix halves, the old trees freed as
  they go) is ``torch.equal`` on all five trees to the compute-then-select
  path it replaces, over rounds with fractional weights; on a comm step
  the gate rides when the lazy row is 0 wherever the mask is (read from
  the values: a copied or rebuilt mask rides too), and a donated masked
  round whose gate cannot ride raises, naming why;
* an async run of reduced qwen3 (token batches, a module template on
  ``meta``) keeps every unapplied client's rows bit for bit;
* ``figures.py --fig async`` equals the reference's ``AsyncTrainer`` runs
  of ``benchmarks/async_throughput.py``'s problem: virtual times, applies
  and rejects exactly.

The reference's shard_map case runs through ``ShardMapBackend`` in
``test_torch_distributed.py`` (gloo groups); its retrace pin has no
counterpart (eager PyTorch does not trace).
"""
import dataclasses
import math
import sys
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import DepositumConfig as JConfig
from repro.core import StalenessPolicy as JPolicy
from repro.core import StragglerModel as JStraggler
from repro.core import check_bounded_staleness as j_check_bounded
from repro.core import replay_cohorts as j_replay_cohorts
from repro.core import replay_staleness as j_replay_staleness
from repro.core import sync_virtual_time as j_sync_virtual_time
from repro.training.async_runtime import AsyncConfig as JAsyncConfig
from repro.training.async_runtime import AsyncTrainer as JAsyncTrainer
from repro.training.async_runtime import tabulate_batches as j_tabulate
from repro.training.train_loop import TrainerConfig as JTrainerConfig
from repro_torch import figures
from repro_torch.convert import state_from_numpy
from repro_torch.core import (DepositumConfig, MixPlan, MixSchedule,
                              StalenessPolicy, StragglerModel,
                              check_bounded_staleness, init as t_init,
                              local_then_comm_round, replay_cohorts,
                              replay_staleness, sync_virtual_time)
from repro_torch.core import depositum as dep_mod
from repro_torch.core.mixing import as_dense
from repro_torch.core.schedule import apply_schedule
from repro_torch.models.registry import Model
from repro_torch.obs.metrics import MetricSpec
from repro_torch.obs.record import Telemetry
from repro_torch.training import (AsyncConfig, AsyncTrainer, FederatedTrainer,
                                  TrainerConfig, tabulate_batches)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchmarks import async_throughput as j_bench  # noqa: E402

N, D, T0, B = 4, 6, 2, 3
CPU = dict(device="cpu")
# final states, port against reference: relative L2 (x, y, nu, g)
STATE_REL = 1e-5
TREES = ("x", "y", "nu", "mu", "g")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Small CPU ops run faster on few threads beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _JModel(NamedTuple):
    cfg: object
    init: object
    forward_train: object
    loss: object
    forward_decode: object
    init_decode_cache: object


def _ls_loss_j(params, batch):
    e = batch["x"] @ params["w"] - batch["y"]
    return jnp.mean(e * e), {}


def _ls_loss_t(params, batch):
    e = batch["x"] @ params["w"] - batch["y"]
    return torch.mean(e * e), {}


def _models(d=D):
    """The reference tests' ``_ls_model`` in both packages: least squares
    ON the batch, so trajectories depend on which round's batches each
    client consumed — exactly what the async driver varies."""
    j = _JModel(None, lambda key: ({"w": jnp.zeros((d,))}, None), None,
                _ls_loss_j, None, None)
    t = Model(cfg=None, init=lambda seed: ({"w": torch.zeros(d)}, None),
              forward_train=None, loss=_ls_loss_t, forward_decode=None,
              init_decode_cache=None)
    return j, t


def _cfg(n=N, log_every=1, fused="auto"):
    return TrainerConfig(
        n_clients=n, topology="ring", log_every=log_every,
        depositum=DepositumConfig(alpha=0.05, comm_period=T0,
                                  prox_name="l1", prox_kwargs={"lam": 1e-4},
                                  fused=fused))


def _jcfg(n=N, log_every=1):
    return JTrainerConfig(
        n_clients=n, topology="ring", log_every=log_every,
        depositum=JConfig(alpha=0.05, comm_period=T0, prox_name="l1",
                          prox_kwargs={"lam": 1e-4}))


def _np_batches(rounds, n=N, d=D, seed=0):
    rng = np.random.default_rng(seed)
    return [{"x": rng.normal(size=(T0, n, B, d)).astype(np.float32),
             "y": rng.normal(size=(T0, n, B)).astype(np.float32)}
            for _ in range(rounds)]


def _round_batches(rounds, n=N, d=D, seed=0):
    return [{k: torch.from_numpy(v) for k, v in b.items()}
            for b in _np_batches(rounds, n, d, seed)]


def _rel(a: torch.Tensor, b) -> float:
    b = torch.from_numpy(np.array(b))
    return float(torch.linalg.vector_norm(a - b)
                 / max(float(torch.linalg.vector_norm(b)), 1e-30))


def _assert_equal_states(a, b, msg=""):
    assert a.t == b.t, msg
    for f in TREES:
        for k in getattr(a, f):
            assert torch.equal(getattr(a, f)[k], getattr(b, f)[k]), (msg, f)


def _run_once(straggler, async_cfg, rounds=6, telemetry=None, fused="auto"):
    tr = AsyncTrainer(_models()[1], _cfg(fused=fused), straggler=straggler,
                      async_cfg=async_cfg, telemetry=telemetry, **CPU)
    state, hist = tr.run(tr.init_state(0),
                         tabulate_batches(iter(_round_batches(rounds)),
                                          rounds), rounds)
    return tr, state, hist


# ---------------------------------------------------------------------------
# Straggler draws, policy and replay helpers against the reference
# ---------------------------------------------------------------------------

# (constructor name, args, kwargs, faults) built in both packages
STRAGGLERS = {
    "zero": ("zero", (N,), {}, None),
    "deterministic": ("deterministic", ([0.2, 0.5, 1.0, 4.0],), {}, None),
    "exponential": ("exponential", (1.0, N), {"seed": 3}, None),
    "exponential-per-client": ("exponential", ([0.5, 1.0, 1.5, 2.0],),
                               {"seed": 7}, None),
    "heavytail": ("heavytail", (1.0, N), {"seed": 5, "shape": 2.0}, None),
    "zero-faults": ("zero", (N,), {}, dict(p_drop=0.3, p_dup=0.4,
                                           dead=(1,))),
    "deterministic-faults": ("deterministic", ([0.2, 0.5, 1.0, 4.0],), {},
                             dict(p_drop=0.25, p_dup=0.25, dead=(3, 2))),
    "exponential-faults": ("exponential", (0.7, N), {"seed": 9},
                           dict(p_drop=0.3, p_dup=0.3)),
    "heavytail-faults": ("heavytail", (1.5, N), {"seed": 2, "shape": 3.0},
                         dict(p_drop=0.2, p_dup=0.5, dead=(0,))),
}


def _both(name):
    ctor, args, kw, faults = STRAGGLERS[name]
    out = []
    for cls in (JStraggler, StragglerModel):
        sm = getattr(cls, ctor)(*args, **kw)
        if faults is not None:
            sm = sm.with_faults(**faults)
        out.append(sm)
    return out


@pytest.mark.parametrize("name", sorted(STRAGGLERS))
def test_straggler_draws_bit_equal_reference(name):
    j, t = _both(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.nominal() == j.nominal()
    for c in range(N):
        for w in range(40):
            assert t.delay(c, w) == j.delay(c, w), (c, w)
            assert t.dropped(c, w) == j.dropped(c, w), (c, w)
            assert t.duplicated(c, w) == j.duplicated(c, w), (c, w)
            assert t.dup_lag(c, w) == j.dup_lag(c, w), (c, w)
    assert sync_virtual_time(t, 9) == j_sync_virtual_time(j, 9)


@pytest.mark.parametrize("bad", [
    lambda m: m.StragglerModel(kind="nope", scale=(1.0,)),
    lambda m: m.StragglerModel.heavytail(1.0, 2, shape=1.0),
    lambda m: m.StragglerModel.zero(2, dead=(5,)),
    lambda m: m.StragglerModel.deterministic([1.0, -0.5]),
    lambda m: m.StragglerModel.exponential(1.0, 2).with_faults(p_drop=1.5),
    lambda m: m.StragglerModel.exponential(1.0, 2).with_faults(p_dup=-0.1),
    lambda m: m.StalenessPolicy(tau=-1),
    lambda m: m.StalenessPolicy(mode="maybe"),
    lambda m: m.StalenessPolicy(mode="downweight", decay=0.0),
    lambda m: m.StalenessPolicy(decay=1.5),
], ids=["kind", "shape", "dead", "scale", "p_drop", "p_dup", "tau", "mode",
        "decay0", "decay>1"])
def test_validation_errors_match_reference(bad):
    import repro.core.staleness as jmod
    import repro_torch.core.staleness as tmod
    with pytest.raises(ValueError) as je:
        bad(jmod)
    with pytest.raises(ValueError) as te:
        bad(tmod)
    assert str(te.value) == str(je.value)


def test_straggler_draws_are_pure_functions_of_args():
    sm = StragglerModel.exponential(1.0, N, seed=7).with_faults(
        p_drop=0.4, p_dup=0.4)
    fwd = [(sm.delay(c, w), sm.dropped(c, w), sm.duplicated(c, w))
           for c in range(N) for w in range(5)]
    bwd = [(sm.delay(c, w), sm.dropped(c, w), sm.duplicated(c, w))
           for c in reversed(range(N)) for w in reversed(range(5))]
    assert fwd == list(reversed(bwd))  # call order is irrelevant


def test_straggler_kinds_and_validation():
    assert StragglerModel.zero(3).delay(0, 0) == 0.0
    det = StragglerModel.deterministic([0.5, 1.5])
    assert det.delay(1, 7) == 1.5 and det.nominal() == 1.0
    exp = StragglerModel.exponential(2.0, 4, seed=1)
    draws = [exp.delay(0, w) for w in range(200)]
    assert 1.0 < np.mean(draws) < 4.0 and np.std(draws) > 0
    ht = StragglerModel.heavytail(2.0, 4, seed=1, shape=3.0)
    assert 0.5 < np.mean([ht.delay(1, w) for w in range(400)]) < 8.0
    assert math.isinf(StragglerModel.zero(2, dead=(1,)).delay(1, 0))


def test_staleness_policy_validation_and_weights():
    pol = StalenessPolicy(tau=3, mode="downweight", decay=0.5)
    assert pol.admits(3) and not pol.admits(4)
    assert pol.weight(2) == 0.25
    assert StalenessPolicy(tau=1).weight(1) == 1.0
    for tau, mode, decay in ((3, "downweight", 0.5), (2, "reject", 0.5),
                             (4, "downweight", 0.3)):
        t = StalenessPolicy(tau=tau, mode=mode, decay=decay)
        j = JPolicy(tau=tau, mode=mode, decay=decay)
        assert [t.admits(s) for s in range(6)] == [j.admits(s)
                                                   for s in range(6)]
        assert [t.weight(s) for s in range(6)] == [j.weight(s)
                                                   for s in range(6)]
    assert AsyncConfig(tau=2, mode="downweight", decay=0.25).policy() == \
        StalenessPolicy(tau=2, mode="downweight", decay=0.25)


def test_replay_helpers_match_reference():
    sm = StragglerModel.exponential(0.8, N, seed=4).with_faults(
        p_drop=0.3, p_dup=0.3)
    tr, _s, _h = _run_once(sm, AsyncConfig(tau=2), rounds=8)
    ev = tr.events
    assert replay_staleness(ev) == j_replay_staleness(ev)
    assert replay_cohorts(ev) == j_replay_cohorts(ev)
    check_bounded_staleness(ev, 2)
    j_check_bounded(ev, 2)
    bad = [dict(e) for e in ev]
    applies = [e for e in bad if e["type"] == "apply"]
    assert any(e["staleness"] > 0 for e in applies)
    for fn in (check_bounded_staleness, j_check_bounded):
        with pytest.raises(AssertionError, match="older than tau"):
            fn(bad, 0)
        with pytest.raises(AssertionError, match="applied twice"):
            fn(bad + [dict(applies[0], round=99)], 2)
    assert replay_staleness([]) == j_replay_staleness([]) == []


# ---------------------------------------------------------------------------
# Event logs and final states against the reference's AsyncTrainer.run
# ---------------------------------------------------------------------------

def _reference_run(name, acfg, rounds):
    jmodel, _ = _models()
    jsm, _ = _both(name)
    jtr = JAsyncTrainer(jmodel, _jcfg(), straggler=jsm,
                        async_cfg=JAsyncConfig(**acfg))
    jb = [{k: jnp.asarray(v) for k, v in b.items()}
          for b in _np_batches(rounds)]
    jstate, jhist = jtr.run(jtr.init_state(jax.random.PRNGKey(0)),
                            j_tabulate(iter(jb), rounds), rounds)
    return jtr, jstate, jhist


@pytest.mark.parametrize("name,acfg", [
    ("zero", dict(tau=0)),
    ("deterministic", dict(tau=2)),
    ("exponential", dict(tau=2)),
    ("heavytail", dict(tau=2)),
    ("zero-faults", dict(tau=1)),
    ("deterministic-faults", dict(tau=2)),
    ("exponential-faults", dict(tau=2)),
    ("heavytail-faults", dict(tau=3)),
    ("exponential-per-client", dict(tau=3, mode="downweight", decay=0.5)),
])
def test_event_log_and_state_match_reference(name, acfg):
    rounds = 6
    jtr, jstate, jhist = _reference_run(name, acfg, rounds)
    _, tsm = _both(name)
    _, tmodel = _models()
    tr = AsyncTrainer(tmodel, _cfg(), straggler=tsm,
                      async_cfg=AsyncConfig(**acfg), **CPU)
    state0 = state_from_numpy(jtr.init_state(jax.random.PRNGKey(0)), **CPU)
    state, hist = tr.run(state0, tabulate_batches(
        iter(_round_batches(rounds)), rounds), rounds)
    assert tr.events == jtr.events
    assert tr.virtual_time == jtr.virtual_time
    assert tr.window == jtr.window
    assert state.t == int(jstate.t)
    for f in ("x", "y", "nu", "g"):
        rel = _rel(getattr(state, f)["w"], getattr(jstate, f)["w"])
        assert rel <= STATE_REL, (f, rel)
    keys = ("round", "virtual_t", "cohort_size")
    assert [{k: h[k] for k in keys} for h in hist] == \
        [{k: h[k] for k in keys} for h in jhist]


@pytest.mark.parametrize("fused", ["auto", "off"])
def test_tau0_zero_delay_torch_equal_to_sync_trainer(fused):
    """The port's keystone, in place of the reference's bit-exact pin."""
    rounds = 5
    _, model = _models()
    cfg = _cfg(fused=fused)
    batches = _round_batches(rounds)
    plan = as_dense(MixPlan.from_topology("ring", N, **CPU), N)
    sync = FederatedTrainer(model, cfg, schedule=MixSchedule.constant(plan),
                            **CPU)
    s_sync, _ = sync.run(sync.init_state(0), iter(batches), rounds)
    atr = AsyncTrainer(model, cfg, straggler=StragglerModel.zero(N),
                       async_cfg=AsyncConfig(tau=0), **CPU)
    s_async, _ = atr.run(atr.init_state(0),
                         tabulate_batches(iter(batches), rounds), rounds)
    _assert_equal_states(s_sync, s_async, "async tau=0/zero-delay drifted "
                                          "from the synchronous trainer")
    for cohort in replay_cohorts(atr.events):
        assert sorted(cohort) == list(range(N))
    assert replay_staleness(atr.events) == [0.0] * rounds


# ---------------------------------------------------------------------------
# Replay determinism, bounded staleness, downweight
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make_straggler", [
    lambda: StragglerModel.exponential(1.0, N, seed=3),
    lambda: StragglerModel.heavytail(1.0, N, seed=5, shape=2.0),
    lambda: StragglerModel.exponential(0.7, N, seed=9).with_faults(
        p_drop=0.3, p_dup=0.3),
    lambda: StragglerModel.deterministic([0.2, 0.5, 1.0, 4.0], dead=(2,)),
], ids=["exponential", "heavytail", "faults", "det-dead"])
def test_replay_determinism(make_straggler):
    """Same seeds ⇒ identical event order AND bit-identical final state."""
    acfg = AsyncConfig(tau=2)
    tr1, s1, _ = _run_once(make_straggler(), acfg)
    tr2, s2, _ = _run_once(make_straggler(), acfg)
    assert tr1.events == tr2.events
    assert tr1.virtual_time == tr2.virtual_time
    _assert_equal_states(s1, s2, "replay produced a different trajectory")


@settings(max_examples=8, deadline=None)
@given(tau=st.integers(min_value=0, max_value=3),
       mean=st.floats(min_value=0.3, max_value=2.0),
       seed=st.integers(min_value=0, max_value=10_000),
       kind=st.sampled_from(["exponential", "heavytail", "deterministic"]),
       faulty=st.booleans())
def test_bounded_staleness_invariant(tau, mean, seed, kind, faulty):
    """No applied update older than τ; nothing applied twice — for any
    (τ, delay distribution, seed, fault) point; and the recorded tick
    staleness equals the replay-log recompute."""
    if kind == "exponential":
        sm = StragglerModel.exponential(mean, N, seed=seed)
    elif kind == "heavytail":
        sm = StragglerModel.heavytail(mean, N, seed=seed, shape=2.0)
    else:
        sm = StragglerModel.deterministic(
            [mean * (i + 1) / N for i in range(N)])
    if faulty:
        sm = sm.with_faults(p_drop=0.25, p_dup=0.25)
    rounds = 4
    tr, _state, _h = _run_once(sm, AsyncConfig(tau=tau), rounds=rounds)
    check_bounded_staleness(tr.events, tau)
    ticks = [e for e in tr.events if e["type"] == "tick"]
    assert [e["round"] for e in ticks] == list(range(rounds))
    assert [e["staleness_mean"] for e in ticks] == replay_staleness(tr.events)


def test_downweight_policy_scales_weights_by_age():
    sm = StragglerModel.exponential(1.5, N, seed=11)
    tr, state, _ = _run_once(sm, AsyncConfig(tau=3, mode="downweight",
                                             decay=0.5))
    applies = [e for e in tr.events if e["type"] == "apply"]
    assert applies
    assert any(e["staleness"] > 0 for e in applies)  # the knob is exercised
    for e in applies:
        assert e["weight"] == 0.5 ** e["staleness"]
    for f in TREES:
        assert all(bool(torch.isfinite(v).all())
                   for v in getattr(state, f).values())


# ---------------------------------------------------------------------------
# Fault injection: duplicates, drops, dead clients
# ---------------------------------------------------------------------------

def test_duplicated_arrivals_are_rejected():
    sm = StragglerModel.exponential(0.8, N, seed=2).with_faults(p_dup=1.0)
    tr, _state, _ = _run_once(sm, AsyncConfig(tau=2))
    rejects = [e for e in tr.events
               if e["type"] == "reject" and e["reason"] == "duplicate"]
    assert rejects, "p_dup=1 produced no duplicate rejections"
    applied = [(e["client"], e["work_round"]) for e in tr.events
               if e["type"] == "apply"]
    assert len(applied) == len(set(applied)), "a work item applied twice"


def test_dropped_arrivals_retry_and_never_deadlock():
    # every arrival lost: nothing ever applies, yet all rounds close
    sm = StragglerModel.deterministic([0.5] * N, p_drop=1.0)
    tr, state, _ = _run_once(sm, AsyncConfig(tau=1), rounds=4)
    assert sum(1 for e in tr.events if e["type"] == "tick") == 4
    assert not [e for e in tr.events if e["type"] == "apply"]
    drops = [e for e in tr.events if e["type"] == "drop"]
    assert drops
    # dropped clients re-dispatch: later work_rounds appear
    assert max(e["work_round"] for e in drops) > 0
    # no cohort: every row frozen, t still advances
    assert state.t == 4 * T0
    assert torch.equal(state.x["w"], torch.zeros(N, D))
    # intermittent drops: progress resumes
    sm2 = StragglerModel.deterministic([0.5] * N, p_drop=0.5)
    tr2, _s2, _ = _run_once(sm2, AsyncConfig(tau=1), rounds=6)
    assert [e for e in tr2.events if e["type"] == "apply"]


def test_dead_client_degrades_cohort_without_deadlock():
    rounds = 6
    sm = StragglerModel.deterministic([0.5] * N, dead=(1,))
    tel = Telemetry.memory(MetricSpec(buffer=rounds + 1))
    tr, state, _ = _run_once(sm, AsyncConfig(tau=1), rounds=rounds,
                             telemetry=tel)
    assert all(1 not in c for c in replay_cohorts(tr.events))
    events = tr.telemetry.events(0)
    assert len(events) == rounds
    # the degraded cohort shows through the EXISTING cohort_size metric
    assert all(e["cohort_size"] == N - 1 for e in events)
    # the dead client's rows never move
    for f in TREES:
        assert torch.equal(getattr(state, f)["w"][1], torch.zeros(D)), f


def test_all_dead_cohort_raises_instead_of_hanging():
    sm = StragglerModel.deterministic([0.5] * N, dead=tuple(range(N)))
    tr = AsyncTrainer(_models()[1], _cfg(), straggler=sm, **CPU)
    with pytest.raises(RuntimeError, match="dead"):
        tr.run(tr.init_state(0),
               tabulate_batches(iter(_round_batches(2)), 2), 2)


def test_sync_virtual_time_is_infinite_with_dead_clients():
    sm = StragglerModel.deterministic([0.5] * N, dead=(0,))
    assert math.isinf(sync_virtual_time(sm, 3))
    assert sync_virtual_time(StragglerModel.deterministic([1.0, 2.0]),
                             3) == 6.0


# ---------------------------------------------------------------------------
# Driver mechanics: skip-ahead, batch gather, adapters, validation
# ---------------------------------------------------------------------------

def test_learner_skips_ahead_past_empty_windows():
    """All clients slower than the window: T_k jumps to the earliest
    arrival instead of spinning empty rounds."""
    sm = StragglerModel.deterministic([5.0] * N)
    tr, _state, _ = _run_once(sm, AsyncConfig(tau=0, window=1.0), rounds=3)
    for cohort in replay_cohorts(tr.events):
        assert sorted(cohort) == list(range(N))
    ticks = [e["t"] for e in tr.events if e["type"] == "tick"]
    assert ticks == [5.0, 10.0, 15.0]


def test_gather_batches_mixes_work_round_columns():
    tr = AsyncTrainer(_models()[1], _cfg(), straggler=StragglerModel.zero(N),
                      **CPU)
    batches = _round_batches(3)
    # token batches (T0, n, B, L) as well as float ones
    rng = np.random.default_rng(5)
    for b in batches:
        b["tokens"] = torch.from_numpy(
            rng.integers(0, 100, size=(T0, N, B, 7)).astype(np.int32))
    bf = lambda r: batches[min(r, 2)]
    # clients 0, 2 on work round 0; client 3 straggling in with round 2 work
    cohort = {0: (0, 1.0, 0), 2: (0, 1.0, 0), 3: (2, 1.0, 1)}
    got = tr._gather_batches(bf, cohort)
    for key in ("x", "y", "tokens"):
        for col, r in ((0, 0), (1, 0), (2, 0), (3, 2)):
            assert torch.equal(got[key][:, col], batches[r][key][:, col])
        assert got[key].dtype == batches[0][key].dtype
    # the source batches are untouched
    assert not torch.equal(batches[0]["x"][:, 3], got["x"][:, 3])
    # single-round cohorts take the fast path: the round's batches verbatim
    same = tr._gather_batches(bf, {0: (1, 1.0, 0), 1: (1, 1.0, 0)})
    assert same is batches[1]


def test_tabulate_batches_clamps_past_the_end():
    bf = tabulate_batches(iter([1, 2, 3]), 3)
    assert [bf(r) for r in (0, 1, 2, 7)] == [1, 2, 3, 3]


def test_async_trainer_validates_operands():
    cfg = _cfg()
    with pytest.raises(ValueError, match="straggler"):
        AsyncTrainer(_models()[1], cfg,
                     straggler=StragglerModel.zero(N + 1), **CPU)
    tr = AsyncTrainer(_models()[1], cfg, straggler=StragglerModel.zero(N),
                      **CPU)
    assert tr.plan.kind == "dense"  # any topology densifies up front
    with pytest.raises(TypeError, match="batch_fn"):
        tr.run(tr.init_state(0), iter(_round_batches(2)), 2)


def test_async_history_matches_trainer_cadence():
    rounds = 7
    tr = AsyncTrainer(_models()[1], _cfg(log_every=3),
                      straggler=StragglerModel.zero(N), telemetry=True,
                      **CPU)
    _state, history = tr.run(
        tr.init_state(0),
        tabulate_batches(iter(_round_batches(rounds)), rounds), rounds)
    assert [h["round"] for h in history] == [3, 6, 7]
    for rec in history:
        assert np.isfinite(rec["loss"])
        assert rec["cohort_size"] == N
        assert "staleness" in rec and rec["staleness"] == 0.0


# ---------------------------------------------------------------------------
# Threaded mode: explicit deadlines of a few seconds
# ---------------------------------------------------------------------------

def test_threaded_mode_keeps_invariants_with_dead_client():
    rounds = 5
    sm = StragglerModel.deterministic([0.2] * N, dead=(2,))
    tr = AsyncTrainer(_models()[1], _cfg(), straggler=sm,
                      async_cfg=AsyncConfig(tau=3), **CPU)
    state, events = tr.run_threaded(
        tr.init_state(0),
        tabulate_batches(iter(_round_batches(rounds)), rounds), rounds,
        time_scale=0.01, deadline_s=10.0)
    check_bounded_staleness(events, 3)
    assert sum(1 for e in events if e["type"] == "tick") == rounds
    assert all(e["client"] != 2 for e in events if e["type"] == "apply")
    assert torch.equal(state.x["w"][2], torch.zeros(D))
    for f in TREES:
        assert all(bool(torch.isfinite(v).all())
                   for v in getattr(state, f).values())


def test_threaded_mode_deadline_raises_instead_of_hanging():
    # live-but-glacial clients: nothing arrives before the deadline
    sm = StragglerModel.deterministic([10_000.0] * N)
    tr = AsyncTrainer(_models()[1], _cfg(), straggler=sm, **CPU)
    with pytest.raises(RuntimeError, match="deadline"):
        tr.run_threaded(tr.init_state(0),
                        tabulate_batches(iter(_round_batches(2)), 2), 2,
                        time_scale=0.01, deadline_s=1.0)
    # all clients dead raises up front, before any window
    smd = StragglerModel.zero(N, dead=tuple(range(N)))
    trd = AsyncTrainer(_models()[1], _cfg(), straggler=smd, **CPU)
    with pytest.raises(RuntimeError, match="dead"):
        trd.run_threaded(trd.init_state(0),
                         tabulate_batches(iter(_round_batches(2)), 2), 2,
                         deadline_s=5.0)


# ---------------------------------------------------------------------------
# tests/test_obs.py's async cases
# ---------------------------------------------------------------------------

def _obs_trainer(telemetry, seed=3):
    sm = StragglerModel.exponential(1.0, N, seed=seed).with_faults(
        p_drop=0.2, p_dup=0.2)
    return AsyncTrainer(_models()[1], _cfg(), straggler=sm,
                        async_cfg=AsyncConfig(tau=2), telemetry=telemetry,
                        **CPU)


def _obs_run(trainer, rounds):
    return trainer.run(trainer.init_state(0), tabulate_batches(
        iter(_round_batches(rounds)), rounds), rounds)


def test_async_staleness_stream_matches_replay_recompute():
    """The recorded ``staleness`` stream IS the replay log's recompute:
    per-round mean staleness of applied arrivals, in float32, with empty
    cohorts recording 0.0.  Recorder rounds are 1-based; the replay list
    indexes learner rounds from 0."""
    rounds = 8
    tel = Telemetry.memory(MetricSpec(buffer=rounds + 1))
    tr = _obs_trainer(tel)
    _obs_run(tr, rounds)
    events = tel.events(0)
    assert len(events) == rounds
    rep = replay_staleness(tr.events)
    cohorts = replay_cohorts(tr.events)
    assert any(s > 0 for s in rep), "no stale applies; test is vacuous"
    for e in events:
        k = e["round"] - 1
        assert np.float32(e["staleness"]) == np.float32(rep[k])
        assert e["cohort_size"] == len(cohorts[k])


def test_async_metrics_on_is_bitexact_with_metrics_off():
    """Attaching telemetry must not perturb the async trajectory: same
    straggler seeds, metrics on vs off, bit-identical final states and
    identical replay logs."""
    rounds = 6
    tr_on, tr_off = _obs_trainer(True), _obs_trainer(None)
    s_on, _ = _obs_run(tr_on, rounds)
    s_off, _ = _obs_run(tr_off, rounds)
    assert tr_on.events == tr_off.events
    _assert_equal_states(s_on, s_off)


# ---------------------------------------------------------------------------
# The donated masked round: gate in the kernels, keep from the halves
# ---------------------------------------------------------------------------

# per-round weights: fractional, zero and full rows, as downweight gives
MASKS = [[1.0, 0.5, 0.0, 0.25], [0.0, 1.0, 0.5, 0.0],
         [0.25, 0.0, 1.0, 1.0], [1.0, 1.0, 1.0, 1.0], [0.0, 0.0, 0.5, 0.0]]


def _lazy_round(w, dev="cpu"):
    plan = as_dense(MixPlan.from_topology("ring", N, device=dev), N)
    return MixSchedule(kind="lazy", plan=plan,
                       active=torch.tensor([w], dtype=torch.float32))


def _gated_state(dtype):
    gen = torch.Generator().manual_seed(11)
    params = {"w": torch.randn(D, 3, generator=gen).to(dtype),
              "b": torch.randn(5, generator=gen).to(dtype)}
    state = t_init(params, N, **CPU)
    return state._replace(**{f: {k: (torch.randn(v.shape, generator=gen)
                                      * 0.1).to(dtype)
                                  for k, v in getattr(state, f).items()}
                             for f in ("y", "nu", "g")})


def _gated_grad_fn():
    def grad_fn(x, batch):
        g = {k: torch.tanh(v * batch) + 0.01 * v for k, v in x.items()}
        return g, {"loss": torch.stack([torch.sum(v.float()) for v in
                                        g["w"]])}
    return grad_fn


def _copy(state):
    return state._replace(**{f: {k: v.clone() for k, v in
                                 getattr(state, f).items()} for f in TREES})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_donated_masked_round_equals_compute_then_select(dtype,
                                                         monkeypatch):
    """Item 3: under the kernel gate the donated masked round (gate in the
    kernels on local and comm steps, keep from the pre-mix halves) equals
    the path it replaces — the gate in the kernels on local steps only,
    the post-mix select from the old state (a plain callable mixer, which
    the round cannot see through) — on all five trees; in fp32 also the
    unfused compute-then-select round (in bf16 the unfused step rounds
    each operation to bf16, the kernel once)."""
    T0r = 3
    cfg = DepositumConfig(alpha=0.05, beta=0.7, gamma=0.8, comm_period=T0r,
                          prox_name="mcp",
                          prox_kwargs={"lam": 1e-3, "theta": 4.0},
                          fused="auto")
    grad_fn = _gated_grad_fn()
    gates = []
    real = dep_mod.fused_local_update

    def spy(*args, **kw):
        gates.append(args[4] is not None if len(args) > 4
                     else kw.get("mask") is not None)
        return real(*args, **kw)

    monkeypatch.setattr(dep_mod, "fused_local_update", spy)
    new = ref_old = unfused = _gated_state(dtype)
    x0 = {k: v.clone() for k, v in new.x.items()}
    for r, w in enumerate(MASKS):
        batches = torch.full((T0r,), 0.3 + 0.1 * r)
        sched = _lazy_round(w)
        gates.clear()
        given = _copy(new)
        new, _ = local_then_comm_round(given, batches, grad_fn, cfg, sched,
                                       active_mask=sched.active[0],
                                       donate=True)
        # the new path gates every step, the comm step included, and
        # consumed its donated input
        assert gates == [True] * T0r
        assert all(not getattr(given, f) for f in ("x", "y", "nu", "g"))
        gates.clear()
        ref_old, _ = local_then_comm_round(
            ref_old, batches, grad_fn, cfg,
            lambda tree, s=sched: apply_schedule(s, 0, tree),
            active_mask=sched.active[0])
        assert gates == [True] * (T0r - 1) + [False]
        unfused, _ = local_then_comm_round(
            unfused, batches, grad_fn,
            dataclasses.replace(cfg, fused="off"), sched,
            active_mask=sched.active[0])
        _assert_equal_states(new, ref_old, f"round {r} vs the outer select")
        if dtype == torch.float32:
            _assert_equal_states(new, unfused, f"round {r} vs unfused")
    # client rows frozen in every round stay bit for bit where they began
    never = [c for c in range(N) if all(m[c] == 0.0 for m in MASKS)]
    for k, v in x0.items():
        for c in never:
            assert torch.equal(new.x[k][c], v[c])


LAZY_ROW = [1.0, 0.5, 0.0, 1.0]


@pytest.mark.parametrize("mask,rides", [
    (lambda s: s.active[0], True),                   # the row itself
    (lambda s: s.active[0].clone(), True),           # a copy
    (lambda s: torch.tensor(LAZY_ROW), True),        # rebuilt from values
    (lambda s: torch.tensor([1.0, 0.5, 1.0, 1.0]), True),   # more live
    (lambda s: torch.tensor([1.0, 0.0, 0.0, 1.0]), False),  # reads a frozen
], ids=["row", "copy", "rebuilt", "more-live", "mix-reads-frozen"])
def test_lazy_gate_reads_the_mask_values(mask, rides):
    """On a comm step the gate rides in the kernels when the lazy row is 0
    wherever the mask is (decided from the values, not from which tensor
    the mask is); else the outer selects stay, and a donated round
    refuses.  Either way the state equals the outer-select path's (a plain
    callable mixer, which the round cannot see through)."""
    cfg = DepositumConfig(alpha=0.05, comm_period=1, prox_name="l1",
                          prox_kwargs={"lam": 1e-4}, fused="auto")
    sched = _lazy_round(LAZY_ROW)
    m = mask(sched)
    state = _gated_state(torch.float32)
    seen = []
    real = dep_mod.fused_tracking

    def spy(*args, **kw):
        seen.append(args[4] is not None)
        return real(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dep_mod, "fused_tracking", spy)
        a, _ = local_then_comm_round(_copy(state), torch.ones(1),
                                     _gated_grad_fn(), cfg, sched,
                                     active_mask=m)
        b, _ = local_then_comm_round(
            _copy(state), torch.ones(1), _gated_grad_fn(), cfg,
            lambda tree: apply_schedule(sched, 0, tree), active_mask=m)
    assert seen == [rides, False]
    _assert_equal_states(a, b)
    if rides:
        given = _copy(state)
        c, _ = local_then_comm_round(given, torch.ones(1), _gated_grad_fn(),
                                     cfg, sched, active_mask=m, donate=True)
        assert not given.x and not given.g
        _assert_equal_states(a, c)
    else:
        with pytest.raises(ValueError, match="does not mask the rows"):
            local_then_comm_round(_copy(state), torch.ones(1),
                                  _gated_grad_fn(), cfg, sched,
                                  active_mask=m, donate=True)


@pytest.mark.parametrize("fused,generic,match", [
    ("off", False, "fused='off'"),
    ("auto", True, "does not mask the rows"),
], ids=["unfused", "generic-mixer"])
def test_donated_masked_round_without_the_kernel_gate_raises(fused, generic,
                                                             match):
    """A donated masked round whose gate cannot ride in the kernels says
    why, instead of keeping the old state alive in silence."""
    cfg = DepositumConfig(alpha=0.05, comm_period=2, prox_name="l1",
                          prox_kwargs={"lam": 1e-4}, fused=fused)
    sched = _lazy_round(LAZY_ROW)
    mixer = (lambda tree: apply_schedule(sched, 0, tree)) if generic \
        else sched
    with pytest.raises(ValueError, match=match):
        local_then_comm_round(_gated_state(torch.float32), torch.ones(2),
                              _gated_grad_fn(), cfg, mixer,
                              active_mask=sched.active[0], donate=True)


# ---------------------------------------------------------------------------
# A module model: reduced qwen3 on token batches
# ---------------------------------------------------------------------------

def test_async_reduced_qwen3_keeps_unapplied_rows():
    """A slow client: the first round applies client 0 only (client 1's
    rows stay bit for bit), the next ones mix work rounds on token
    batches (a stale apply at weight 0.5)."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_federated_lm_streams
    from repro_torch.models import build_model
    from repro_torch.training import lm_batch_iterator

    cfg = get_config("qwen3-1.7b", reduced=True)
    model = build_model(cfg, **CPU)
    n, rounds = 2, 3
    tcfg = TrainerConfig(n_clients=n, topology="complete", log_every=1,
                         depositum=DepositumConfig(
                             alpha=0.01, comm_period=2, prox_name="l1",
                             prox_kwargs={"lam": 1e-5}, fused="auto"))
    tr = AsyncTrainer(model, tcfg,
                      straggler=StragglerModel.deterministic([0.5, 3.0]),
                      async_cfg=AsyncConfig(tau=1, mode="downweight"), **CPU)
    module, _ = model.init(0)
    state = tr.state_from_params(module)
    assert next(module.parameters()).device.type == "meta"
    stream = make_federated_lm_streams(cfg.vocab_size, n, seed=0)
    bf = tabulate_batches(lm_batch_iterator(stream, tcfg, 2, 16, **CPU),
                          rounds)
    before = _copy(state)
    state, hist = tr.run(state, bf, 1, donate=True)
    assert replay_cohorts(tr.events) == [[0]]
    assert np.isfinite(hist[-1]["loss"])
    for f in TREES:
        for k, v in getattr(state, f).items():
            assert torch.equal(v[1], getattr(before, f)[k][1]), (f, k)
    moved = any(not torch.equal(v[0], before.x[k][0])
                for k, v in state.x.items())
    assert moved
    state, hist = tr.run(state, bf, rounds, donate=True)
    applies = [e for e in tr.events if e["type"] == "apply"]
    assert any(e["staleness"] == 1 and e["weight"] == 0.5 for e in applies)
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert isinstance(tr.mean_params(state), torch.nn.Module)


# ---------------------------------------------------------------------------
# figures.py --fig async against benchmarks/async_throughput.py
# ---------------------------------------------------------------------------

def test_async_figure_matches_reference_benchmark():
    rounds = 6
    rows = {r["distribution"]: r for r in figures.async_run(rounds,
                                                            device="cpu")}
    assert rows["zero"]["sync_equal"]
    assert rows["zero"]["applies"] == figures.ASYNC_N * rounds
    jmodel, jcfg, jbatches, _, n = j_bench._problem(False)
    # the same draws: the first rounds of the full problem's batches
    _, _, tbatches = figures.async_problem(rounds, device="cpu")
    for jb, tb in zip(jbatches, tbatches):
        for k in jb:
            assert np.array_equal(np.asarray(jb[k]), tb[k].numpy())
    for name, jsm in j_bench._distributions(n).items():
        jtr = JAsyncTrainer(jmodel, jcfg, straggler=jsm,
                            async_cfg=JAsyncConfig(tau=figures.ASYNC_TAU))
        jtr.run(jtr.init_state(jax.random.PRNGKey(0)),
                j_tabulate(iter(jbatches), rounds), rounds)
        row = rows[name]
        assert row["events"] == jtr.events
        assert row["async_virtual_time"] == jtr.virtual_time
        assert row["sync_virtual_time"] == j_sync_virtual_time(jsm, rounds)
        assert row["applies"] == sum(e["type"] == "apply"
                                     for e in jtr.events)
        assert row["rejects"] == sum(e["type"] == "reject"
                                     for e in jtr.events)
    check = figures.async_check(list(rows.values()))
    assert check["zero_sync_equal"] and check["headline_met"]
    with pytest.raises(ValueError, match="sequential"):
        figures.async_run(2, True, "cpu")
