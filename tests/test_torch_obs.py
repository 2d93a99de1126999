"""Port parity: telemetry (``obs/metrics.py``, ``obs/record.py``,
``obs/sinks.py``) and its hooks in the sweep engine, the trainer and the
quickstart harness.

Ports the non-``slow`` cases of ``tests/test_obs.py`` (the async ones wait
for the async runtime).  Eager PyTorch has no trace, so the reference's
retrace-count pins become spies: a cadence or sink change alters neither
the trajectory (bit for bit), nor the gradient calls, nor the recorder's
host copies.  Beyond them:

* ``round_values`` on one state (dense, lazy and cohort schedules, and a
  sweep of S = 3) against the reference's ``round_values`` on the same
  numpy state: rtol 1e-6 (the same fp32 operations; sums in another
  order), ``wire_bytes`` and ``cohort_size`` exactly;
* the consensus terms bit-equal to the port's ``stationarity_metrics``;
* the JSONL the port writes passes the reference's ``validate_jsonl`` and
  holds the same lines the reference writes for the same events;
* the recorder copies its buffer to the host once every B logged rows and
  once at the end (``host_copies``), never a round;
* the program's spans and counters (``obs/trace.py``) record nothing with
  tracing off, are host events but not user annotations under a profiler,
  cover a reduced qwen3 grad step with backward halves and the remat
  recompute, leave losses and gradients bit-equal, and count the casts'
  bytes as the shapes give them.
"""
import collections
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CohortSampler as JSampler
from repro.core import DepositumConfig as JConfig
from repro.core import DepositumState as JState
from repro.core import Hyper as JHyper
from repro.core import MixPlan as JPlan
from repro.core import MixSchedule as JSched
from repro.obs.metrics import round_values as j_round_values
from repro.obs.sinks import JsonlSink as JJsonlSink
from repro.obs.sinks import validate_jsonl as j_validate_jsonl
from repro_torch.analysis.comm import payload_row_bytes, round_wire_bytes
from repro_torch.core import (CohortSampler, CompressionSpec, DepositumConfig,
                              DepositumState, Hyper, MixPlan, MixSchedule,
                              stack_hypers, stack_specs, stationarity_metrics)
from repro_torch.models.registry import Model
from repro_torch.obs.metrics import (MetricSpec, round_values,
                                     traced_payload_row_bytes,
                                     traced_round_bytes)
from repro_torch.obs.record import Telemetry
from repro_torch.obs.sinks import (JsonlSink, MemorySink, validate_event,
                                   validate_jsonl)
from repro_torch.training.sweep import sweep_run, sweep_run_sequential
from repro_torch.training.train_loop import FederatedTrainer, TrainerConfig

N, D, T0 = 4, 12, 2
CPU = dict(device="cpu")
RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Shared problem: per-client least squares (composite with l1 prox)
# ---------------------------------------------------------------------------

def _ls_problem(n=N, d=D, seed=0, calls=None):
    rng = np.random.default_rng(seed)
    A = torch.from_numpy((rng.standard_normal((n, 16, d)) * 0.3)
                         .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32))

    def grad_fn(x, batch):
        if calls is not None:
            calls.append(1)
        r = torch.einsum("nkd,nd->nk", A, x["w"]) - b
        return {"w": 2.0 * torch.einsum("nkd,nk->nd", A, r) / A.shape[1]}, {}

    return grad_fn, A, b


def _cfg(**kw):
    kw.setdefault("alpha", 0.05)
    kw.setdefault("comm_period", T0)
    kw.setdefault("prox_name", "l1")
    kw.setdefault("prox_kwargs", {"lam": 1e-4})
    return DepositumConfig(**kw)


def _sched(n=N):
    return MixSchedule.constant(MixPlan.dense(np.full((n, n), 1.0 / n), **CPU))


def _batches(rounds, n=N):
    return torch.zeros((rounds, T0, n, 1))


def _toy_model(d=D, seed=0, calls=None):
    """A zoo-shaped model whose aux has no ``"ce"`` (the loss fallback)."""
    rng = np.random.default_rng(seed)
    A = torch.from_numpy((rng.standard_normal((16, d)) * 0.3)
                         .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(16).astype(np.float32))

    def loss(params, batch):
        if calls is not None:
            calls.append(1)
        r = A @ params["w"] - b
        return torch.mean(r * r), {}

    return Model(cfg=None, init=lambda seed: ({"w": torch.zeros(d)}, None),
                 forward_train=None, loss=loss, forward_decode=None,
                 init_decode_cache=None)


def _trainer_batches(n=N):
    while True:
        yield torch.zeros((T0, n, 1))


def _leaves(state):
    return [v for f in ("x", "y", "nu", "mu", "g")
            for v in getattr(state, f).values()]


def _assert_bits(a, b):
    for u, v in zip(_leaves(a), _leaves(b)):
        assert torch.equal(u, v)
    assert a.t == b.t


# ---------------------------------------------------------------------------
# MetricSpec / sinks
# ---------------------------------------------------------------------------

def test_metric_spec_validates():
    assert MetricSpec().n_metrics == 9
    with pytest.raises(ValueError):
        MetricSpec(names=("prox_grad_sq", "nope"))
    with pytest.raises(ValueError):
        MetricSpec(buffer=0)


def test_validate_event_rejects_malformed():
    names = ("prox_grad_sq",)
    ok = {"config": 0, "round": 3, "prox_grad_sq": 0.5}
    validate_event(ok, names)
    validate_event({**ok, "prox_grad_sq": float("nan")}, names)
    with pytest.raises(ValueError):
        validate_event({**ok, "round": -1}, names)
    with pytest.raises(ValueError):
        validate_event({**ok, "prox_grad_sq": float("inf")}, names)
    with pytest.raises(ValueError):
        validate_event({"config": 0, "prox_grad_sq": 0.5}, names)
    with pytest.raises(ValueError):
        validate_event({**ok, "config": True}, names)


def test_jsonl_sink_roundtrip_and_schema(tmp_path):
    path = str(tmp_path / "events.jsonl")
    sink = JsonlSink(path)
    events = [{"config": 0, "round": 1, "loss": 0.5},
              {"config": 1, "round": 1, "loss": float("nan")}]
    sink.write(events)
    sink.close()
    assert validate_jsonl(path, ("loss",)) == 2
    assert j_validate_jsonl(path, ("loss",)) == 2
    rows = [json.loads(line) for line in open(path)]
    assert [r["config"] for r in rows] == [0, 1]
    # the reference's sink writes the same lines for the same events
    jpath = str(tmp_path / "ref.jsonl")
    jsink = JJsonlSink(jpath)
    jsink.write(events)
    jsink.close()
    assert open(path).read() == open(jpath).read()
    with open(path, "a") as f:
        f.write(json.dumps({"config": 0, "round": 0, "loss": "oops"}) + "\n")
    with pytest.raises(ValueError):
        validate_jsonl(path, ("loss",))


def test_ring_buffer_overflow_recovers_latest_rows():
    """More logged rounds than buffer rows: the host keeps the newest B
    and never emits a row twice."""
    spec = MetricSpec(names=("loss",), buffer=3)
    tel = Telemetry(spec, [MemorySink()])
    carry = tel.init_carry(**CPU)
    for r in range(7):
        carry = tel.record(carry, {"loss": torch.tensor(float(r))}, r, 1)
    tel.emit(carry)
    tel.emit(carry)  # the same buffer again: nothing new
    tel.sync()
    events = tel.events(0)
    assert [e["round"] for e in events] == [5, 6, 7]
    assert [e["loss"] for e in events] == [4.0, 5.0, 6.0]
    assert tel.host_copies == 1


def test_host_copies_once_every_B_rows():
    """Emitting every round copies the buffer when it is full of new rows
    and once at the end: ceil(rows / B) copies, every row once, in order."""
    spec = MetricSpec(names=("loss",), buffer=4)
    for rows in (3, 4, 9, 12):
        tel = Telemetry(spec, [MemorySink()])
        carry = tel.init_carry(2, **CPU)                 # a sweep of two
        copies = []
        for r in range(rows):
            carry = tel.record_and_emit(
                carry, {"loss": torch.tensor([r, -r], dtype=torch.float32)},
                r, 1)
            copies.append(tel.host_copies)
        assert copies == [(r + 1) // 4 for r in range(rows)]
        tel.sync()
        assert tel.host_copies == math.ceil(rows / 4)
        for s, sign in ((0, 1), (1, -1)):
            assert tel.stream("loss", s) == [sign * float(r)
                                             for r in range(rows)]
            assert tel.memory_sink.rounds(s) == list(range(1, rows + 1))


def test_each_carry_keeps_its_own_progress():
    """Two runs on one recorder, the same tag: each fresh carry starts at
    0 and emits all its rows; nothing stays pending after a sync."""
    spec = MetricSpec(names=("loss",), buffer=2)
    tel = Telemetry(spec, [MemorySink()])
    for run in range(2):
        carry = tel.init_carry(**CPU)
        assert carry.emitted == {}
        for r in range(3):
            carry = tel.record_and_emit(
                carry, {"loss": torch.tensor(float(10 * run + r))}, r, 1)
        tel.sync()
        assert carry.emitted == {0: 3}
        assert tel._pending == []
    assert tel.stream("loss", 0) == [0.0, 1.0, 2.0, 10.0, 11.0, 12.0]
    assert tel.host_copies == 4


# ---------------------------------------------------------------------------
# Bytes on the wire == analysis.comm
# ---------------------------------------------------------------------------

SPECS = {
    "no spec": lambda: None,
    "none": lambda: CompressionSpec.none(**CPU),
    "topk": lambda: CompressionSpec.topk(0.1, **CPU),
    "topk wire_k": lambda: CompressionSpec.topk(0.25, wire_k=7, **CPU),
    "randk": lambda: CompressionSpec.randk(0.05, **CPU),
    "qsgd": lambda: CompressionSpec.qsgd(4.0, **CPU),
}


@pytest.mark.parametrize("name", list(SPECS))
def test_traced_payload_bytes_match_host(name):
    spec = SPECS[name]()
    for d in (10, 257, 4096):
        got = float(traced_payload_row_bytes(spec, d, **CPU))
        want = float(payload_row_bytes(spec, d))
        assert got == want, (name, d, got, want)


def test_traced_payload_bytes_mixed_kinds():
    mixed = stack_specs([CompressionSpec.none(**CPU),
                         CompressionSpec.topk(0.1, **CPU),
                         CompressionSpec.qsgd(4.0, **CPU)])
    got = traced_payload_row_bytes(mixed, 128).numpy()
    np.testing.assert_array_equal(got, payload_row_bytes(mixed, 128))


def test_traced_round_bytes_match_host():
    d = 64
    ring = MixPlan.from_topology("ring", N, **CPU)
    cases = [
        (MixSchedule.constant(ring), None),
        (MixSchedule.constant(MixPlan.from_topology("complete", N, **CPU)),
         N),
        (MixSchedule.constant(MixPlan.chebyshev(ring, 3)), None),
        (MixSchedule.constant(ring).with_compression(
            CompressionSpec.topk(0.1, **CPU)), None),
        (MixPlan.from_topology("star", N, **CPU), None),   # a bare plan
    ]
    for sched, n in cases:
        got = float(traced_round_bytes(sched, 0, d, n=n))
        want = float(round_wire_bytes(sched, d, n=n))
        assert got == want, (sched, got, want)


def test_traced_round_bytes_lazy_counts_drawn_mask():
    d = 32
    sched = MixSchedule.lazy(MixPlan.from_topology("ring", N, **CPU), 0.5,
                             rounds=6, seed=3)
    for r in range(6):
        got = float(traced_round_bytes(sched, r, d))
        assert got == float(round_wire_bytes(sched, d, r=r)), r


def test_traced_round_bytes_structureless_mixer_is_nan():
    assert math.isnan(float(traced_round_bytes(lambda t: t, 0, 8)))


# ---------------------------------------------------------------------------
# round_values against the reference's
# ---------------------------------------------------------------------------

def _np_state(lead, seed=1, t=4):
    rng = np.random.default_rng(seed)
    mk = lambda shape: (rng.standard_normal(lead + shape) * 0.5).astype(
        np.float32)
    return {f: {"l0": {"w": mk((D, 3)), "b": mk((3,))}}
            for f in ("x", "y", "nu", "mu", "g")}, t


def _port_state(tree, t):
    flat = lambda d: {"l0.b": torch.from_numpy(d["l0"]["b"]),
                      "l0.w": torch.from_numpy(d["l0"]["w"])}
    return DepositumState(**{f: flat(v) for f, v in tree.items()}, t=t)


def _ref_state(tree, t):
    return JState(**{f: jax.tree_util.tree_map(jnp.asarray, v)
                     for f, v in tree.items()}, t=jnp.int32(t))


def _schedules(kind, n):
    if kind == "dense":
        return (JSched.constant(JPlan.from_topology("ring", n)),
                MixSchedule.constant(MixPlan.from_topology("ring", n, **CPU)))
    if kind == "lazy":
        W = np.asarray(MixPlan.from_topology("ring", n, **CPU).W)
        return (JSched.lazy(JPlan.dense(W), 0.6, rounds=5, seed=2),
                MixSchedule.lazy(MixPlan.dense(W, **CPU), 0.6, rounds=5,
                                 seed=2))
    raise ValueError(kind)


def _close(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in got.items():
        w = np.asarray(want[k], np.float32)
        g = v.numpy()
        if k in ("wire_bytes", "cohort_size", "staleness"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif k == "loss":
            np.testing.assert_allclose(g, w, rtol=RTOL, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0, err_msg=k)


@pytest.mark.parametrize("kind", ["dense", "lazy"])
def test_round_values_match_reference(kind):
    n = 6
    tree, t = _np_state((n,))
    jcfg = JConfig(alpha=0.05, beta=0.7, comm_period=T0, prox_name="mcp",
                   prox_kwargs={"lam": 1e-2, "theta": 4.0})
    cfg = DepositumConfig(alpha=0.05, beta=0.7, comm_period=T0,
                          prox_name="mcp",
                          prox_kwargs={"lam": 1e-2, "theta": 4.0})
    jsched, sched = _schedules(kind, n)
    loss = np.linspace(0.5, 1.5, n).astype(np.float32)
    want = jax.jit(lambda st: j_round_values(
        st, jcfg, mixer=jsched, aux={"loss": jnp.asarray(loss)}, n=n))(
            _ref_state(tree, t))
    got = round_values(_port_state(tree, t), cfg, mixer=sched,
                       aux={"loss": torch.from_numpy(loss)}, n=n)
    _close(got, want)


def test_round_values_cohort_match_reference():
    """A cohort schedule over a padded axis: weights from the sampler's
    eligibility, this round's mask injected into both."""
    n_max, n_eff = 8, 6
    tree, t = _np_state((n_max,), seed=3, t=6)
    W = np.asarray(MixPlan.from_topology("ring", n_max, **CPU).W)
    mask = np.array([1, 0, 1, 1, 0, 1, 0, 0], np.float32)
    jsched = JSched.cohort(JPlan.dense(W), JSampler.bernoulli(
        0.5, n_max, seed=1, n_eff=n_eff))
    sched = MixSchedule.cohort(MixPlan.dense(W, **CPU), CohortSampler.bernoulli(
        0.5, n_max, seed=1, n_eff=n_eff, **CPU))
    cfg_kw = dict(alpha=0.05, comm_period=T0, prox_name="l1",
                  prox_kwargs={"lam": 1e-3})
    want = jax.jit(lambda st: j_round_values(
        st, JConfig(**cfg_kw), mixer=jsched,
        active_mask=jnp.asarray(mask)))(_ref_state(tree, t))
    got = round_values(_port_state(tree, t), DepositumConfig(**cfg_kw),
                       mixer=sched, active_mask=torch.from_numpy(mask))
    _close(got, want)
    assert float(got["cohort_size"]) == mask.sum()


def test_round_values_sweep_match_reference_points():
    """S = 3 points with their own Hyper and stacked W, in one batched
    call: each point equal to the reference's value on that point, and to
    the port's one-config value there (rtol 1e-6: the batched reduction
    sums each point's leaf in another order)."""
    S, n = 3, 5
    tree, t = _np_state((S, n), seed=4, t=2)
    topos = ("ring", "star", "complete")
    hps = [dict(alpha=a, beta=b, lam=1e-2, theta=3.0)
           for a, b in ((0.03, 1.0), (0.05, 0.5), (0.08, 0.7))]
    from repro_torch.core import stack_mixplans
    plans = [MixPlan.from_topology(tp, n, **CPU) for tp in topos]
    plans = [MixPlan.dense(np.asarray(p.W) if p.W is not None else
                           np.full((n, n), 1.0 / n), **CPU) for p in plans]
    cfg = DepositumConfig(comm_period=T0, prox_name="scad",
                          prox_kwargs={"lam": 1e-2, "theta": 3.0})
    got = round_values(_port_state(tree, t), cfg,
                       hyper=stack_hypers([Hyper.create(**h) for h in hps]),
                       mixer=stack_mixplans(plans), n=n, sweep=True)
    jcfg = JConfig(comm_period=T0, prox_name="scad",
                   prox_kwargs={"lam": 1e-2, "theta": 3.0})
    for s in range(S):
        point = jax.tree_util.tree_map(lambda v: v[s], tree)
        want = jax.jit(lambda st, h, W: j_round_values(
            st, jcfg, hyper=h, mixer=JPlan.dense(W), n=n))(
                _ref_state(point, t), JHyper.create(**hps[s]),
                jnp.asarray(np.asarray(plans[s].W)))
        _close({k: v[s] for k, v in got.items()}, want)
        one = round_values(_port_state(point, t), cfg,
                           hyper=Hyper.create(**hps[s]), mixer=plans[s], n=n)
        for k, v in one.items():
            np.testing.assert_allclose(got[k][s].numpy(), v.numpy(),
                                       rtol=1e-6, err_msg=k)


def test_round_values_cohort_sweep_matches_its_points():
    """A stacked cohort schedule on the sweep axis (per-point eligibility
    weights and masks): each point's values equal the one-config values on
    that point's state and schedule."""
    S, n_max = 2, 8
    tree, t = _np_state((S, n_max), seed=5, t=4)
    W = MixPlan.from_topology("ring", n_max, **CPU)
    from repro_torch.core import stack_schedules
    points = [MixSchedule.cohort(W, CohortSampler.bernoulli(
        p, n_max, seed=3, n_eff=ne, **CPU)) for p, ne in ((0.5, 6), (1.0, 8))]
    cfg = _cfg()
    got = round_values(_port_state(tree, t), cfg,
                       mixer=stack_schedules(points), sweep=True)
    for s in range(S):
        point = jax.tree_util.tree_map(lambda v: v[s], tree)
        one = round_values(_port_state(point, t), cfg, mixer=points[s])
        for k, v in one.items():
            np.testing.assert_allclose(got[k][s].numpy(), v.numpy(),
                                       rtol=RTOL, err_msg=f"{s}: {k}")


# ---------------------------------------------------------------------------
# Metrics on = metrics off, bit for bit
# ---------------------------------------------------------------------------

def test_trainer_metrics_on_is_bitexact():
    rounds = 5
    cfg = TrainerConfig(n_clients=N, depositum=_cfg(), log_every=2)
    model = _toy_model()
    off = FederatedTrainer(model, cfg, schedule=_sched(), **CPU)
    on = FederatedTrainer(model, cfg, schedule=_sched(), **CPU,
                          telemetry=Telemetry(MetricSpec(buffer=rounds + 1)))
    s_off, _ = off.run(off.init_state(0), _trainer_batches(), rounds)
    s_on, _ = on.run(on.init_state(0), _trainer_batches(), rounds)
    _assert_bits(s_off, s_on)
    assert [e["round"] for e in on.telemetry.events(0)] == [2, 4, 5]
    assert on.telemetry.host_copies == 1


@pytest.mark.parametrize("run", [sweep_run, sweep_run_sequential])
def test_sweep_metrics_on_is_bitexact(run):
    rounds = 4
    grad_fn, _, _ = _ls_problem()
    hypers = stack_hypers([Hyper.create(alpha=a, lam=1e-4)
                           for a in (0.03, 0.05)])
    params0 = {"w": torch.zeros(D)}
    s_off, _ = run(params0, grad_fn, _cfg(), _sched(), hypers,
                   _batches(rounds), n_clients=N)
    tel = Telemetry(MetricSpec(buffer=rounds + 1))
    s_on, _ = run(params0, grad_fn, _cfg(), _sched(), hypers,
                  _batches(rounds), n_clients=N, telemetry=tel)
    _assert_bits(s_off, s_on)
    for s in range(2):
        assert tel.memory_sink.rounds(s) == [1, 2, 3, 4]
    if run is sweep_run:       # the grid backend forwards its recorder
        from repro_torch.training.backends import SweepBackend
        tel2 = Telemetry(MetricSpec(buffer=rounds + 1))
        s_be, _ = SweepBackend().run(params0, grad_fn, _cfg(), _sched(),
                                     hypers, _batches(rounds), n_clients=N,
                                     telemetry=tel2, log_every=2)
        _assert_bits(s_off, s_be)
        assert tel2.memory_sink.rounds(1) == [2, 4]


# ---------------------------------------------------------------------------
# Recorded streams == post-hoc recompute
# ---------------------------------------------------------------------------

def test_recorded_streams_match_posthoc_recompute():
    """Every recorded metric equals the sweep engine's own per-round
    ``metrics_fn`` output at the logged rounds (the one-config
    ``round_values`` on each point), and the final-round consensus terms
    equal a fresh ``stationarity_metrics`` recompute, bit for bit."""
    rounds, log_every = 6, 2
    grad_fn, A, b = _ls_problem()
    cfg = _cfg()
    hypers = stack_hypers([Hyper.create(alpha=a, lam=1e-4)
                           for a in (0.03, 0.05, 0.08)])

    def metrics_fn(state, hyper, plan):
        return round_values(state, cfg, hyper=hyper, mixer=plan, aux={},
                            n=N)

    tel = Telemetry(MetricSpec(buffer=rounds + 1))
    final, outs = sweep_run({"w": torch.zeros(D)}, grad_fn, cfg, _sched(),
                            hypers, _batches(rounds), n_clients=N,
                            metrics_fn=metrics_fn, telemetry=tel,
                            log_every=log_every)
    logged = [r for r in range(1, rounds + 1)
              if r % log_every == 0 or r == rounds]
    sink = tel.memory_sink
    for s in range(3):
        assert sink.rounds(s) == logged
        for name in MetricSpec().names:
            rec = np.asarray(sink.stream(name, s), np.float32)
            want = outs[name][s].numpy()[np.asarray(logged) - 1]
            if name == "loss":
                assert np.isnan(rec).all() and np.isnan(want).all()
                continue
            np.testing.assert_array_equal(rec, want, err_msg=f"{s}: {name}")

    def global_at(x):
        r = torch.einsum("nkd,sd->snk", A, x["w"]) - b
        g = 2.0 * torch.einsum("nkd,snk->snd", A, r) / A.shape[1]
        return {"w": torch.mean(g, dim=1)}

    def local_at(x):
        return grad_fn(x, None)[0]

    for s in range(3):
        point = DepositumState(**{f: {k: v[s] for k, v in getattr(
            final, f).items()} for f in ("x", "y", "nu", "mu", "g")},
            t=final.t)
        sm = stationarity_metrics(
            point, {"global_at": global_at, "local_at": local_at}, cfg,
            hyper=Hyper(*(v[s] for v in hypers)))
        for rec_name, sm_name in (("consensus_x", "consensus_x"),
                                  ("consensus_y", "consensus_y"),
                                  ("momentum_var", "consensus_nu")):
            rec = sink.stream(rec_name, s)[-1]
            assert rec == float(sm[sm_name]), (rec_name, s)


# ---------------------------------------------------------------------------
# Cadence and sink changes: the spies that replace the retrace pins
# ---------------------------------------------------------------------------

def test_trainer_cadence_and_sink_toggles_do_not_retrace():
    calls = []
    cfg = TrainerConfig(n_clients=N, depositum=_cfg(), log_every=1)
    tr = FederatedTrainer(_toy_model(calls=calls), cfg, schedule=_sched(),
                          telemetry=Telemetry(MetricSpec(buffer=8)), **CPU)
    ref = FederatedTrainer(_toy_model(), cfg, schedule=_sched(), **CPU)
    state, _ = tr.run(tr.init_state(0), _trainer_batches(), 3)
    s_ref, _ = ref.run(ref.init_state(0), _trainer_batches(), 3)
    baseline, copies = len(calls), tr.telemetry.host_copies
    assert baseline == 3 * T0 * N and copies == 1
    tr.cfg.log_every = 2                      # cadence change
    tr.telemetry.sinks = [MemorySink()]       # sink swap
    state, _ = tr.run(state, _trainer_batches(), 3)
    s_ref, _ = ref.run(s_ref, _trainer_batches(), 3)
    _assert_bits(state, s_ref)
    assert len(calls) == 2 * baseline
    assert tr.telemetry.host_copies == 2 * copies
    assert [e["round"] for e in tr.telemetry.events(0)] == [4, 6]


def test_sweep_cadence_and_sink_toggles_do_not_retrace():
    calls = []
    grad_fn, _, _ = _ls_problem(calls=calls)
    hypers = stack_hypers([Hyper.create(alpha=a, lam=1e-4)
                           for a in (0.03, 0.05)])
    tel = Telemetry(MetricSpec(buffer=8))
    kw = dict(n_clients=N, telemetry=tel)
    base, _ = sweep_run({"w": torch.zeros(D)}, grad_fn, _cfg(), _sched(),
                        hypers, _batches(3), **kw)
    per_run, copies = len(calls), tel.host_copies
    assert per_run > 0 and copies == 1
    tel.sinks = [MemorySink(), MemorySink()]  # sink swap
    for le in (2, 3, 7):                      # cadence changes
        before = len(calls)
        st, _ = sweep_run({"w": torch.zeros(D)}, grad_fn, _cfg(), _sched(),
                          hypers, _batches(3), log_every=le, **kw)
        _assert_bits(st, base)
        assert len(calls) - before == per_run
        copies += 1
        assert tel.host_copies == copies
    # le 2: rounds 2 and 3 (the final); le 3 and 7: the final round only
    assert tel.sinks[0].rounds(0) == [2, 3, 3, 3]


# ---------------------------------------------------------------------------
# Trainer history: no silent gaps, loss fallback; the harness
# ---------------------------------------------------------------------------

def test_trainer_history_records_final_round_off_cadence():
    cfg = TrainerConfig(n_clients=N, depositum=_cfg(), log_every=10)
    tr = FederatedTrainer(_toy_model(), cfg, schedule=_sched(), **CPU)
    _, history = tr.run(tr.init_state(0), _trainer_batches(), 7)
    assert [h["round"] for h in history] == [7]
    assert np.isfinite(history[0]["loss"])


def test_trainer_history_cadence_is_explicit():
    cfg = TrainerConfig(n_clients=N, depositum=_cfg(), log_every=2)
    tr = FederatedTrainer(_toy_model(), cfg, schedule=_sched(), **CPU,
                          telemetry=True)
    _, history = tr.run(tr.init_state(0), _trainer_batches(), 7)
    assert [h["round"] for h in history] == [2, 4, 6, 7]
    for rec in history:
        assert "consensus_x" in rec and "wire_bytes" in rec
        assert np.isfinite(rec["loss"])
        assert rec["wire_bytes"] == N * (N - 1) * D * 4 * 2
        assert rec["staleness"] == 0.0 and rec["cohort_size"] == N


def test_trainer_timer_accumulates():
    cfg = TrainerConfig(n_clients=N, depositum=_cfg(), log_every=1)
    tr = FederatedTrainer(_toy_model(), cfg, schedule=_sched(), **CPU,
                          telemetry=True)
    tr.run(tr.init_state(0), _trainer_batches(), 3)
    t = tr.timer.timing()
    assert t.blocked_us > 0 and tr.timer.rounds == 3


def test_quickstart_records_streams_and_keeps_the_trajectory(tmp_path):
    from repro_torch.quickstart import (ExperimentConfig, run_depositum,
                                        run_depositum_grid)
    cfg = ExperimentConfig(model="mlp", n_clients=N, rounds=3, batch=4,
                           n_features=D, n_classes=3, n_samples=160,
                           hidden=(8, 4))
    s_off, _ = run_depositum(cfg, collect_metrics=False, **CPU)
    tel = Telemetry.jsonl(str(tmp_path / "run.jsonl"))
    s_on, curves = run_depositum(cfg, collect_metrics=False, telemetry=tel,
                                 **CPU)
    _assert_bits(s_off, s_on)
    assert curves["recorded_round"] == [1, 2, 3]
    tel.close()
    assert j_validate_jsonl(str(tmp_path / "run.jsonl"),
                            MetricSpec().names) == 3
    rows = run_depositum_grid([cfg, cfg], telemetry=Telemetry.memory(), **CPU)
    assert rows[0]["recorded_wire_bytes"] == rows[1]["recorded_wire_bytes"]
    import dataclasses
    other = dataclasses.replace(cfg, n_clients=N + 1)
    with pytest.raises(ValueError, match="single static-config group"):
        run_depositum_grid([cfg, other], telemetry=Telemetry.memory(), **CPU)


# ---------------------------------------------------------------------------
# Spans and counters (obs/trace.py): on only under a profiler or recording()
# ---------------------------------------------------------------------------

def _qwen(remat=False, policy="full", dtype="float32"):
    """(config, grad_fn, stacked x of 2 clients, batch) of reduced qwen3."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_grad_fn
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config("qwen3-1.7b", reduced=True),
                              remat=bool(remat), remat_policy=policy,
                              dtype=dtype)
    model = build_model(cfg, device="cpu")
    module, _ = model.init(0)
    x = {k: torch.stack([p.detach(), 1.01 * p.detach()])
         for k, p in module.named_parameters()}
    toks = torch.randint(0, cfg.vocab_size, (2, 2, 17),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    return cfg, make_grad_fn(model, template=module), x, batch


def _qwen_trainer():
    """A reduced-qwen3 trainer on 2 clients, T0 1 (every step gossips),
    its state and token batches."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_federated_lm_streams
    from repro_torch.models import build_model
    from repro_torch.training.train_loop import lm_batch_iterator
    cfg = get_config("qwen3-1.7b", reduced=True)
    tc = TrainerConfig(n_clients=2, topology="complete", log_every=1,
                       depositum=DepositumConfig(comm_period=1, fused="auto"))
    tr = FederatedTrainer(build_model(cfg, device="cpu"), tc, **CPU)
    it = lm_batch_iterator(make_federated_lm_streams(cfg.vocab_size, 2), tc,
                           batch=2, seq_len=16, **CPU)
    return tr, tr.init_state(0), it


def _graph_names(t):
    """Names of every autograd node behind ``t``."""
    seen, todo, names = set(), [t.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


MODEL_SPANS = ("model_step", "grad_copy", "block", "attention", "mlp",
               "loss_head", "ce")


def test_tracing_off_records_nothing_and_opens_no_range(monkeypatch):
    from repro_torch.models import build_model
    from repro_torch.obs import trace
    opened = []
    monkeypatch.setattr(trace, "_HostRange",
                        lambda name: opened.append(name) or trace._OFF)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", opened.append)
    trace.STORE.reset()
    assert not trace.on()
    cfg, grad_fn, x, batch = _qwen(remat="full", dtype="bfloat16")
    grad_fn(x, batch)
    tr, state, it = _qwen_trainer()
    tr.run(state, it, 1)
    assert opened == [] and len(trace.STORE) == 0
    assert not trace.STORE.counters
    # no boundary node in the graph off; a control with recording() on
    model = build_model(cfg, device="cpu")
    module, _ = model.init(0)
    one = {k: v[0] for k, v in batch.items()}
    assert not any("Boundary" in n
                   for n in _graph_names(model.loss(module, one)[0]))
    with trace.recording():
        assert trace.on()
        with trace.recording():
            pass
        assert trace.on()
        on_loss = model.loss(module, one)[0]
    assert not trace.on()
    assert _graph_names(on_loss) == _graph_names(model.loss(module, one)[0])


def test_profiler_spans_are_host_events_not_user_annotations():
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import trace
    tr, state, it = _qwen_trainer()
    trace.STORE.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.on()
        tr.run(state, it, 1)
    seen = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in trace.SPANS:
            seen.setdefault(e.name(), set()).add(e.is_user_annotation())
    want = {"round", "round.batch", "round.program", "round.log", "run.sync",
            "gossip", *MODEL_SPANS}
    assert want <= set(seen)
    # fused_kernel stays a user annotation, its sweep launches unlinked
    assert all(flags == {name in trace._USER_RANGES}
               for name, flags in seen.items()), seen
    assert want <= set(trace.STORE.summary())
    # a profiler alone takes no device events: the trace has device times
    assert trace.STORE._used == 0


def _span_tree(spans):
    """(name, phase) -> Counter of the parents' (name, phase)."""
    tree = collections.defaultdict(collections.Counter)
    for sp in spans:
        p = spans[sp.parent] if sp.parent is not None else None
        tree[sp.name, sp.phase][p and (p.name, p.phase)] += 1
    return {k: dict(v) for k, v in tree.items()}


@pytest.mark.parametrize("remat", [False, "full", "dots"])
def test_grad_step_records_the_span_table_and_self_times_add_up(remat):
    from repro_torch.obs import trace
    cfg, grad_fn, x, batch = _qwen(remat=bool(remat), policy=remat or "full")
    with trace.recording():
        grad_fn(x, batch)
    spans = trace.STORE.spans()
    assert all(sp.t1 is not None for sp in spans)
    # two clients; the block's recompute runs in its MLP's backward half
    L, step = cfg.n_layers, ("model_step", "forward")
    want = {step: {None: 2}, ("grad_copy", "forward"): {step: 2},
            ("loss_head", "forward"): {step: 2},
            ("loss_head", "backward"): {step: 2},
            ("ce", "forward"): {step: 2}, ("ce", "backward"): {step: 2},
            ("block", "forward"): {step: 2 * L},
            ("block", "backward"): {step: 2 * L}}
    for n in ("attention", "mlp"):
        for ph in ("forward", "backward"):
            want[n, ph] = {("block", ph): 2 * L}
        if remat:
            want[n, "recompute"] = {("remat", "recompute"): 2 * L}
    if remat:
        want["remat", "recompute"] = {("mlp", "backward"): 2 * L}
    assert _span_tree(spans) == want
    # every interval of a client's model step counts in exactly one span's
    # self time (the host clock; the CPU has no device events)
    rows = trace.STORE.summary(by_phase=True)
    assert all(0 <= r["self_host_s"] <= r["host_s"] for r in rows.values())
    assert all(r["device_s"] == 0 for r in rows.values())
    total_self = sum(r["self_host_s"] for r in rows.values())
    assert total_self == pytest.approx(rows["model_step:forward"]["host_s"],
                                       rel=1e-9)
    trace.STORE.reset()
    assert trace.STORE.summary() == {}


def test_pruned_backward_closes_its_halves():
    """``autograd.grad`` for the last block's MLP alone never reaches the
    inputs of the halves it opens: they close by the backward's end, and
    the next step's spans nest as before."""
    from repro_torch.models import build_model
    from repro_torch.obs import trace
    cfg, grad_fn, x, batch = _qwen()
    model = build_model(cfg, device="cpu")
    module, _ = model.init(0)
    one = {k: v[0] for k, v in batch.items()}
    last = [p for k, p in module.named_parameters()
            if k.startswith(f"blocks.{cfg.n_layers - 1}.mlp")]
    with trace.recording():
        torch.autograd.grad(model.loss(module, one)[0], last)
        assert trace._OPEN == [] and trace.STORE.top() == -1
        n = len(trace.STORE)
        grad_fn(x, batch)
    spans = trace.STORE.spans()
    assert all(sp.t1 is not None for sp in spans)
    pruned = _span_tree(spans[:n])
    assert pruned[("mlp", "backward")] == {("block", "backward"): 1}
    assert ("attention", "backward") not in pruned
    tree = _span_tree([sp._replace(parent=None if sp.parent is None
                                   else sp.parent - n) for sp in spans[n:]])
    assert tree[("block", "backward")] == {("model_step", "forward"):
                                           2 * cfg.n_layers}
    assert tree[("mlp", "backward")] == {("block", "backward"):
                                         2 * cfg.n_layers}


def test_store_holds_one_session_and_no_python_objects_a_span():
    import gc

    from repro_torch.obs import trace
    cfg, grad_fn, x, batch = _qwen(remat="full")
    with trace.recording():
        grad_fn(x, batch)
        first = len(trace.STORE)
        # a span is a row of integers: a traced step leaves behind no
        # more objects for the collector than an untraced one
        gc.collect()
        gc.disable()
        try:
            before = len(gc.get_objects())
            grad_fn(x, batch)
            kept_on = len(gc.get_objects()) - before
        finally:
            gc.enable()
        assert len(trace.STORE) == 2 * first
    gc.collect()
    gc.disable()
    try:
        before = len(gc.get_objects())
        grad_fn(x, batch)
        kept_off = len(gc.get_objects()) - before
    finally:
        gc.enable()
    assert kept_on <= kept_off + 2
    # tracing on anew starts a new session; a full one drops spans
    with trace.recording():
        grad_fn(x, batch)
        assert len(trace.STORE) == first
    old = trace.SpanStore.CAPACITY
    trace.SpanStore.CAPACITY = 5
    try:
        with trace.recording():
            grad_fn(x, batch)
        assert len(trace.STORE) == 5 and trace.STORE.dropped == first - 5
        assert trace.STORE.top() == -1
    finally:
        trace.SpanStore.CAPACITY = old


@pytest.mark.parametrize("remat,dtype", [(False, "float32"),
                                         ("full", "float32"),
                                         ("dots", "float32"),
                                         ("full", "bfloat16")])
def test_tracing_keeps_losses_and_gradients_bit_equal(remat, dtype):
    from repro_torch.obs import trace
    _, grad_fn, x, batch = _qwen(remat=bool(remat), policy=remat or "full",
                                 dtype=dtype)
    g_off, a_off = grad_fn(x, batch)
    with trace.recording():
        g_on, a_on = grad_fn(x, batch)
    assert torch.equal(a_off["ce"], a_on["ce"])
    for k in g_off:
        assert torch.equal(g_off[k], g_on[k]), k


def _cast_reckoning(cfg, B, L, passes):
    """bf16 <-> fp32 bytes read plus written by one client's forward
    (``passes`` 2 under remat: the recompute casts again), from shapes."""
    from repro_torch.models.common import pad_vocab
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    e = 2 + 4
    tok = B * L

    def norm(rows, width):      # x in, the scale, the result out
        return e * (2 * rows * width + width)

    block = (2 * norm(tok, d)                           # ln1, ln2
             + norm(tok * H, hd) + norm(tok * KV, hd)   # q-norm, k-norm
             + 2 * e * tok * (H + KV) * hd              # RoPE of q and k
             + 2 * e * B * H * L * L)                   # scores, probs
    return (cfg.n_layers * passes * block + norm(tok, d)      # final norm
            + e * tok * pad_vocab(cfg.vocab_size))             # CE logits


@pytest.mark.parametrize("remat", [False, True])
def test_cast_bytes_equal_the_reckoning_from_shapes(remat):
    from repro_torch.obs import trace
    cfg, grad_fn, x, batch = _qwen(remat=remat, dtype="bfloat16")
    with trace.recording():
        grad_fn(x, batch)
    B, L = batch["tokens"].shape[1:]
    assert trace.STORE.counters["cast_bytes"] == 2 * _cast_reckoning(
        cfg, B, L, 2 if remat else 1)
    # an fp32 model converts nothing
    _, grad_fn, x, batch = _qwen(remat=remat)
    with trace.recording():
        grad_fn(x, batch)
    assert "cast_bytes" not in trace.STORE.counters
