"""Port parity: client cohorts on a padded client axis.

The reference draws its cohorts with JAX's threefry, which the port does
not reproduce (it hashes ``(seed, r, i)``), so the parity tests inject the
reference's masks into the port's sampler.  Then:

* cohort rounds, one config and a stacked S = 2 sweep, match the reference
  at rtol 1e-5 / atol 1e-6 (the two sum the least-squares gradients in
  another order), fused off and on (in-kernel gate: the plain versions
  here, the reference's Pallas kernels in interpret mode); rows a round
  leaves out, and padding rows, come back bit for bit;
* ``pad_plan`` equals the reference's exactly;
* each padded point of a cohort grid matches its native-size run within
  ``fig_cohort.py``'s acceptance (relative max error < 1e-4), and the
  gated fused sweep equals the unfused one bit for bit.

Property tests (hypothesis, or the ``tests/_propcheck.py`` shim) hold the
port's own sampler: prefix consistency across ``n_max``, the Bernoulli
rate within 5 standard deviations over 40 rounds x 256 clients, and
``fixed_size`` drawing exactly ``min(k, n_eff)``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import CohortSampler as JSampler
from repro.core import DepositumConfig as JConfig
from repro.core import MixPlan as JPlan
from repro.core import MixSchedule as JSched
from repro.core import init as j_init
from repro.core import local_then_comm_round as j_round
from repro.core import pad_plan as j_pad_plan
from repro.core import stack_hypers as j_stack_hypers
from repro.core import stack_schedules as j_stack_schedules
from repro.training.sweep import sweep_run as j_sweep_run
from repro_torch.core import (CohortSampler, DepositumConfig, MixPlan,
                              MixSchedule, init, local_then_comm_round,
                              pad_plan, schedule_round_mask, stack_cohorts,
                              stack_hypers, stack_schedules)
from repro_torch.core.cohort import client_uniforms
from repro_torch.core.schedule import VALIDATE_ROUNDS_CAP
from repro_torch.figures import (COHORT_D, COHORT_T0, cohort_check,
                                 cohort_grad_fn, cohort_run, cohort_setup)
from repro_torch.training.sweep import make_sweep_round, sweep_init, sweep_run

N_MAX, D, M, T0, R = 8, 10, 16, 3, 4
TOL = dict(rtol=1e-5, atol=1e-6)
FIELDS = ("x", "y", "nu", "g")


@functools.lru_cache(maxsize=None)
def _lsq():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((N_MAX, M, D)).astype(np.float32)
    b = np.einsum("nmd,d->nm", A, rng.standard_normal(D).astype(np.float32))
    return A, b


def _j_grad_fn(n):
    A, b = (jnp.asarray(v[:n]) for v in _lsq())

    def grad_fn(w, batch):
        r = jnp.einsum("nmd,nd->nm", A, w[:n]) - b
        g = jnp.einsum("nmd,nm->nd", A, r) / M
        pad = w.shape[0] - n
        if pad:
            g = jnp.concatenate([g, jnp.zeros((pad, D), g.dtype)])
        return g, {}

    return grad_fn


def _t_grad_fn(n):
    A, b = (torch.from_numpy(v[:n]) for v in _lsq())
    return cohort_grad_fn(A, b)


@dataclasses.dataclass(frozen=True)
class Injected(CohortSampler):
    """The port's sampler with another package's masks: ``masks[r]`` is
    round r's (n_max,) or (S, n_max) mask."""

    masks: torch.Tensor = None

    def mask_at(self, r):
        return self.masks[r]

    def point(self, s):
        if not self.is_stacked:
            return self
        return dataclasses.replace(super().point(s), masks=self.masks[:, s])


def _points():
    """(n_eff, p_active, seed) of the grid's points, padded to N_MAX."""
    return [(6, 0.5, 11), (8, 0.7, 3)]


def _j_schedule(n, p, seed):
    return JSched.cohort(j_pad_plan(JPlan.from_topology("ring", n), N_MAX),
                         JSampler.bernoulli(p, N_MAX, seed=seed, n_eff=n))


def _t_schedule(n, p, seed, masks):
    sampler = CohortSampler.bernoulli(p, N_MAX, seed=seed, n_eff=n,
                                      device="cpu")
    fields = {f.name: getattr(sampler, f.name)
              for f in dataclasses.fields(sampler)}
    return MixSchedule.cohort(
        pad_plan(MixPlan.from_topology("ring", n, device="cpu"), N_MAX),
        Injected(**fields, masks=masks))


def _cfg(pkg, fused):
    kw = dict(alpha=0.05, beta=0.5, gamma=0.5, comm_period=T0,
              prox_name="l1", prox_kwargs={"lam": 1e-3}, fused=fused)
    return JConfig(**kw) if pkg == "j" else DepositumConfig(**kw)


def _assert_frozen(before, after, mask):
    """Rows with mask 0 came back bit for bit."""
    idle = mask <= 0
    for f in FIELDS:
        a, b = getattr(after, f)["w"], getattr(before, f)["w"]
        assert torch.equal(a[idle], b[idle]), f"frozen rows of {f} moved"


@pytest.mark.parametrize("fused", ["off", "require"])
def test_one_config_cohort_rounds_match_reference(fused):
    n, p, seed = _points()[0]
    js = _j_schedule(n, p, seed)
    masks = torch.from_numpy(np.stack([np.asarray(js.sampler.mask_at(r))
                                       for r in range(R)]))
    assert 0 < float(masks.sum()) < R * n            # a proper subset
    rnd = jax.jit(functools.partial(j_round, grad_fn=_j_grad_fn(N_MAX),
                                    config=_cfg("j", fused), mixer=js))
    jstate = j_init(jnp.zeros(D), N_MAX)
    ts = _t_schedule(n, p, seed, masks)
    tstate = init({"w": torch.zeros(D)}, N_MAX, device="cpu")
    for r in range(R):
        jstate, _ = rnd(jstate, jnp.zeros((T0, 1)))
        before = tstate
        tstate, _ = local_then_comm_round(tstate, torch.zeros(T0, 1),
                                          _t_grad_fn(N_MAX),
                                          _cfg("t", fused), ts)
        _assert_frozen(before, tstate, masks[r])
        for f in FIELDS:
            np.testing.assert_allclose(getattr(tstate, f)["w"].numpy(),
                                       np.asarray(getattr(jstate, f)),
                                       err_msg=f"round {r} {f}", **TOL)
    for f in FIELDS:                                 # padding rows stay 0
        assert not getattr(tstate, f)["w"][n:].any()


@pytest.mark.parametrize("fused", ["off", "require"])
def test_cohort_sweep_matches_reference_sweep(fused):
    pts = _points()
    jgrid = j_stack_schedules([_j_schedule(*pt) for pt in pts])
    # (rounds, S, n_max); validate_schedule samples up to 16 rounds
    masks = torch.from_numpy(np.stack([
        np.stack([np.asarray(_j_schedule(*pt).sampler.mask_at(r))
                  for pt in pts]) for r in range(VALIDATE_ROUNDS_CAP)]))
    jcfg, tcfg = _cfg("j", fused), _cfg("t", fused)
    jf, _ = j_sweep_run(jnp.zeros(D), _j_grad_fn(N_MAX), jcfg, jgrid,
                        j_stack_hypers([jcfg.hyper()] * 2),
                        jnp.zeros((R, T0, 1)), n_clients=N_MAX)
    samplers = stack_cohorts([CohortSampler.bernoulli(
        p, N_MAX, seed=seed, n_eff=n, device="cpu") for n, p, seed in pts])
    fields = {f.name: getattr(samplers, f.name)
              for f in dataclasses.fields(samplers)}
    tgrid = stack_schedules([_t_schedule(*pt, masks[:, s])
                             for s, pt in enumerate(pts)])
    tgrid = dataclasses.replace(tgrid, sampler=Injected(**fields,
                                                         masks=masks))
    tf, _ = sweep_run({"w": torch.zeros(D)}, _t_grad_fn(N_MAX), tcfg, tgrid,
                      stack_hypers([tcfg.hyper()] * 2),
                      torch.zeros(R, T0, 1), n_clients=N_MAX)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tf, f)["w"].numpy(),
                                   np.asarray(getattr(jf, f)), err_msg=f,
                                   **TOL)
    # round by round: what each point's mask leaves out comes back bit for
    # bit, and padding rows stay exactly 0
    round_fn = make_sweep_round(_t_grad_fn(N_MAX), tcfg, tgrid,
                                batch_axis=None)
    state = sweep_init({"w": torch.zeros(D)}, N_MAX, 2)
    for r in range(R):
        before = state
        state, _ = round_fn(state, tcfg.hyper(), torch.zeros(T0, 1))
        _assert_frozen(before, state, masks[r])
    assert not state.x["w"][0, pts[0][0]:].any()
    for f in FIELDS:
        assert torch.equal(getattr(state, f)["w"], getattr(tf, f)["w"])


def test_pad_plan_matches_reference():
    n = 5
    for prefer in ("dense", "sparse"):           # dense and circulant
        jp = JPlan.from_topology("ring", n, prefer=prefer)
        tp = MixPlan.from_topology("ring", n, prefer=prefer, device="cpu")
        np.testing.assert_array_equal(
            pad_plan(tp, N_MAX, n).W.numpy(),
            np.asarray(j_pad_plan(jp, N_MAX, n).W))
    full = MixPlan.from_topology("ring", N_MAX, device="cpu")
    assert pad_plan(full, N_MAX) is full
    with pytest.raises(ValueError, match="n_max"):
        pad_plan(full, N_MAX - 1)


def test_padded_points_match_native_and_gated_fused_equals_unfused():
    grid = dict(sizes=[4, 8], p_active=[0.5, 1.0], n_max=16)
    rows = cohort_run(rounds=3, device="cpu", fused="require", **grid)
    assert cohort_check(rows)["padded_matches_native"], \
        [r["native_rel_err"] for r in rows]
    assert cohort_check(rows)["full_participation_exact"]
    c = {m: cohort_setup("cpu", m, **grid) for m in ("off", "require")}
    finals = {m: sweep_run(
        {"w": torch.zeros(COHORT_D)}, cohort_grad_fn(c[m].A, c[m].b),
        c[m].config, c[m].grid, c[m].config.hyper(),
        torch.zeros(3, COHORT_T0, 1), n_clients=16)[0] for m in c}
    for f in FIELDS:
        assert torch.equal(getattr(finals["off"], f)["w"],
                           getattr(finals["require"], f)["w"]), f


# ---------------------------------------------------------------------------
# The port's sampler
# ---------------------------------------------------------------------------

@settings(max_examples=15, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**31 - 1),
       r=st.integers(min_value=0, max_value=10_000))
def test_sampler_prefix_consistency(seed, r):
    small = CohortSampler.bernoulli(0.6, N_MAX, seed=seed, device="cpu")
    padded = CohortSampler.bernoulli(0.6, 4 * N_MAX, seed=seed, n_eff=N_MAX,
                                     device="cpu")
    mp = padded.mask_at(r)
    assert torch.equal(mp[:N_MAX], small.mask_at(r))
    assert not mp[N_MAX:].any()            # ineligible rows never activate
    u = client_uniforms(torch.tensor(seed), r, 64)
    assert torch.equal(u[:N_MAX], client_uniforms(torch.tensor(seed), r,
                                                  N_MAX))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


def test_uniforms_not_pinned_at_zero_input():
    # seed 0, round 0, client 0 is the commonest draw: it must be an
    # ordinary uniform, not the mixer's image of an all-zero input
    for seed in (0, 1):
        u = client_uniforms(torch.tensor(seed), 0, N_MAX)
        assert float(u[0]) > 0.0
    s = CohortSampler.bernoulli(1e-6, N_MAX, seed=0, device="cpu")
    assert not s.mask_at(0).any()


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000),
       p=st.floats(min_value=0.0, max_value=1.0))
def test_bernoulli_rate_within_five_sigma(seed, p):
    n, rounds = 256, 40
    s = CohortSampler.bernoulli(p, n, seed=seed, device="cpu")
    masks = torch.stack([s.mask_at(r) for r in range(rounds)])
    assert set(masks.unique().tolist()) <= {0.0, 1.0}
    rate = float(masks.mean())
    assert abs(rate - p) <= 5 * np.sqrt(p * (1 - p) / (n * rounds)) + 1e-6
    assert torch.equal(masks[3], s.mask_at(3))          # deterministic


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000),
       r=st.integers(min_value=0, max_value=100),
       k=st.integers(min_value=1, max_value=N_MAX))
def test_fixed_size_draws_exactly_k(seed, r, k):
    s = CohortSampler.fixed_size(k, N_MAX, seed=seed, device="cpu")
    assert float(s.mask_at(r).sum()) == k
    n_eff = max(1, k // 2)
    s2 = CohortSampler.fixed_size(k, N_MAX, seed=seed, n_eff=n_eff,
                                  device="cpu")
    m2 = s2.mask_at(r)
    assert float(m2.sum()) == min(k, n_eff) and not m2[n_eff:].any()


def test_sampler_stacking_and_guards():
    pts = [CohortSampler.bernoulli(p, N_MAX, seed=s, n_eff=n, device="cpu")
           for p, s, n in ((0.5, 1, 4), (0.9, 2, 8), (0.3, 3, 6))]
    grid = stack_cohorts(pts)
    assert grid.is_stacked and grid.n_sweep == 3
    for r in range(3):
        m = grid.mask_at(r)
        for i, pt in enumerate(pts):
            assert torch.equal(m[i], pt.mask_at(r))
            assert torch.equal(grid.point(i).mask_at(r), pt.mask_at(r))
    assert grid.eligible().sum(-1).tolist() == [4, 8, 6]
    np.testing.assert_allclose(grid.expected_active().numpy(),
                               [2.0, 7.2, 1.8], rtol=1e-6)
    full = CohortSampler.full(5, N_MAX, device="cpu")
    assert full.mask_at(7).tolist() == [1.0] * 5 + [0.0] * 3
    sched = MixSchedule.cohort(MixPlan.from_topology("ring", N_MAX,
                                                     device="cpu"), full)
    assert torch.equal(schedule_round_mask(sched, 2), full.mask_at(2))
    assert schedule_round_mask(MixSchedule.constant(sched.plan), 2) is None
    with pytest.raises(ValueError):
        CohortSampler.bernoulli(1.5, N_MAX, device="cpu")
    with pytest.raises(ValueError):
        CohortSampler.full(N_MAX + 1, N_MAX, device="cpu")
    with pytest.raises(ValueError):
        CohortSampler.fixed_size(0, N_MAX, device="cpu")
    with pytest.raises(ValueError, match="heterogeneous"):
        stack_cohorts([full, pts[0]])
