"""Port parity: one DEPOSITUM step, one round and the paper metrics.

A small MLP (12 -> 16 -> 8 -> 5, 4 clients on a ring, T0 = 3) with the
reference's weights carried across by ``repro_torch.convert``; a random
state made with numpy goes through both packages, fused on and off (the
reference's Pallas kernels in interpret mode, the port's plain versions).

Tolerance: per-client gradients and the dense mix sum in another order
(XLA vs PyTorch matmuls), so states are held at rtol = 1e-5 with atol =
1e-6 after one step or round; frozen cohort rows are held bit for bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import apply_mlp, ce_loss as j_ce, init_mlp
from repro.core import depositum as jdep
from repro.core.gossip import make_dense_mixer as j_mixer
from repro.core.mixing import MixPlan as JPlan
from repro.core.topology import mixing_matrix
from repro_torch.convert import (params_from_numpy, params_to_numpy,
                                 state_from_numpy, state_to_numpy)
from repro_torch.core import depositum as tdep
from repro_torch.core.gossip import make_dense_mixer as t_mixer
from repro_torch.core.mixing import MixPlan as TPlan
from repro_torch.core.schedule import MixSchedule as TSchedule
from repro_torch.models.classifier import MLP, client_grad_fn

C, D_IN, N_CLS, HIDDEN, T0, B = 4, 12, 5, (16, 8), 3, 6
TOL = dict(rtol=1e-5, atol=1e-6)
FIELDS = ("x", "y", "nu", "mu", "g")
MASK = np.array([1, 0, 1, 1], np.float32)


def _cfg(**kw):
    base = dict(alpha=0.05, beta=0.5, gamma=0.8, momentum="polyak",
                comm_period=T0, prox_name="mcp",
                prox_kwargs={"lam": 1e-3, "theta": 4.0})
    base.update(kw)
    return base


@functools.lru_cache(maxsize=None)
def _problem():
    params = init_mlp(jax.random.PRNGKey(0), D_IN, N_CLS, hidden=HIDDEN)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(0)
    noise = lambda v: (rng.standard_normal((C,) + v.shape) * 0.05).astype(
        np.float32)
    state_np = jdep.DepositumState(
        x=jax.tree_util.tree_map(lambda v: v[None] + noise(v), params_np),
        y=jax.tree_util.tree_map(noise, params_np),
        nu=jax.tree_util.tree_map(noise, params_np),
        mu=jax.tree_util.tree_map(lambda v: np.zeros((C,) + v.shape,
                                                     np.float32), params_np),
        g=jax.tree_util.tree_map(noise, params_np),
        t=np.asarray(0, np.int32))
    batches = {"x": rng.standard_normal((T0, C, B, D_IN)).astype(np.float32),
               "y": rng.integers(0, N_CLS, (T0, C, B)).astype(np.int32)}
    return params_np, state_np, batches


def _j_state(state_np, t=0):
    return jdep.DepositumState(
        *(jax.tree_util.tree_map(jnp.asarray, getattr(state_np, f))
          for f in FIELDS), t=jnp.asarray(t, jnp.int32))


def _j_grad_fn():
    grad_one = jax.grad(functools.partial(j_ce, apply_mlp))
    return lambda xs, batch: (jax.vmap(grad_one)(xs, batch), {})


def _t_grad_fn():
    return client_grad_fn(MLP(D_IN, N_CLS, HIDDEN))


def _assert_state_close(ts, js, **tol):
    tn = state_to_numpy(ts)
    for f in FIELDS:
        jf = jax.tree_util.tree_leaves(getattr(js, f))
        tf = jax.tree_util.tree_leaves(tn[f])
        assert len(jf) == len(tf)
        for a, b in zip(tf, jf):
            np.testing.assert_allclose(a, np.asarray(b), **(tol or TOL))
    assert int(tn["t"]) == int(js.t)


@pytest.mark.parametrize("fused,t", [("require", 0),   # local step
                                     ("off", 2)])      # comm step
def test_one_step_matches(fused, t):
    _, state_np, batches = _problem()
    W = mixing_matrix("ring", C)
    kw = _cfg(fused=fused)
    bt = {k: v[0] for k, v in batches.items()}
    j_step = jax.jit(functools.partial(
        jdep.step, grad_fn=_j_grad_fn(), config=jdep.DepositumConfig(**kw),
        mixer=j_mixer(W)))
    js, _ = j_step(_j_state(state_np, t),
                   {k: jnp.asarray(v) for k, v in bt.items()})
    st = state_from_numpy(state_np, device="cpu")._replace(t=t)
    ts, _ = tdep.step(st, {k: torch.from_numpy(v) for k, v in bt.items()},
                      _t_grad_fn(), tdep.DepositumConfig(**kw),
                      t_mixer(W, device="cpu"))
    _assert_state_close(ts, js)


@pytest.mark.parametrize("fused,masked", [("off", False), ("require", True)])
def test_one_round_matches(fused, masked):
    _, state_np, batches = _problem()
    W = mixing_matrix("ring", C)
    kw = _cfg(fused=fused)
    jm = jnp.asarray(MASK) if masked else None
    tm = torch.from_numpy(MASK) if masked else None
    j_round = jax.jit(functools.partial(
        jdep.local_then_comm_round, grad_fn=_j_grad_fn(),
        config=jdep.DepositumConfig(**kw), mixer=JPlan.dense(W)))
    js, _ = j_round(_j_state(state_np),
                    {k: jnp.asarray(v) for k, v in batches.items()},
                    active_mask=jm)
    st = state_from_numpy(state_np, device="cpu")
    ts, _ = tdep.local_then_comm_round(
        st, {k: torch.from_numpy(v) for k, v in batches.items()},
        _t_grad_fn(), tdep.DepositumConfig(**kw),
        TPlan.dense(W, device="cpu"), active_mask=tm)
    _assert_state_close(ts, js)
    if masked:  # frozen rows keep their bits through the whole round
        for f in FIELDS:
            for k, v in getattr(ts, f).items():
                old = getattr(st, f)[k]
                assert torch.equal(v[1].view(torch.int32),
                                   old[1].view(torch.int32)), (f, k)


@pytest.mark.parametrize("weighted", [False, True])
def test_stationarity_metrics_match_every_term(weighted):
    params_np, state_np, _ = _problem()
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((C, 20, D_IN)).astype(np.float32)
    ys = rng.integers(0, N_CLS, (C, 20)).astype(np.int32)
    grad_one = jax.grad(functools.partial(j_ce, apply_mlp))
    j_fns = {
        "local_at": lambda x: jax.vmap(grad_one)(
            x, {"x": jnp.asarray(xs), "y": jnp.asarray(ys)}),
        "global_at": lambda x: jax.vmap(lambda p: grad_one(
            p, {"x": jnp.asarray(xs.reshape(-1, D_IN)),
                "y": jnp.asarray(ys.reshape(-1))}))(x)}
    from repro_torch.models.classifier import stationarity_grad_fns
    t_fns = stationarity_grad_fns(MLP(D_IN, N_CLS, HIDDEN),
                                  torch.from_numpy(xs), torch.from_numpy(ys))
    jw = jnp.asarray(MASK) if weighted else None
    tw = torch.from_numpy(MASK) if weighted else None
    jm = jax.jit(functools.partial(
        jdep.stationarity_metrics, grad_fns=j_fns,
        config=jdep.DepositumConfig(**_cfg()), L=2.0))(_j_state(state_np),
                                                      weights=jw)
    tm = tdep.stationarity_metrics(state_from_numpy(state_np, device="cpu"),
                                   t_fns, tdep.DepositumConfig(**_cfg()),
                                   L=2.0, weights=tw)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(
        float(tdep.consensus_error(state_from_numpy(state_np,
                                                    device="cpu").x, tw)),
        float(jdep.consensus_error(_j_state(state_np).x, jw)), rtol=1e-5)


@pytest.mark.parametrize("kw", [dict(momentum="nesterov"),
                                dict(prox_name="l2sq",
                                     prox_kwargs={"lam": 1e-3})])
def test_fused_require_raises_when_ineligible(kw):
    _, state_np, batches = _problem()
    W = mixing_matrix("ring", C)
    bt = {k: v[0] for k, v in batches.items()}
    cfg = _cfg(fused="require", **kw)
    with pytest.raises(ValueError, match="fused='require'"):
        jdep.step(_j_state(state_np),
                  {k: jnp.asarray(v) for k, v in bt.items()}, _j_grad_fn(),
                  jdep.DepositumConfig(**cfg), j_mixer(W))
    with pytest.raises(ValueError, match="fused='require'"):
        tdep.step(state_from_numpy(state_np, device="cpu"),
                  {k: torch.from_numpy(v) for k, v in bt.items()},
                  _t_grad_fn(), tdep.DepositumConfig(**cfg),
                  t_mixer(W, device="cpu"))
    ok_j, _ = jdep.fused_eligibility(jdep.DepositumConfig(**cfg))
    ok_t, _ = tdep.fused_eligibility(tdep.DepositumConfig(**cfg))
    assert ok_j is ok_t is False


def test_init_padding_and_conversion_round_trip():
    params_np, state_np, _ = _problem()
    js = jdep.init(jax.tree_util.tree_map(jnp.asarray, params_np), C,
                   n_max=C + 2)
    ts = tdep.init(params_from_numpy(params_np, device="cpu"), C,
                   n_max=C + 2, device="cpu")
    _assert_state_close(ts, js, rtol=0, atol=0)
    back = state_to_numpy(state_from_numpy(state_np, device="cpu"))
    for f in FIELDS:
        for a, b in zip(jax.tree_util.tree_leaves(back[f]),
                        jax.tree_util.tree_leaves(getattr(state_np, f))):
            np.testing.assert_array_equal(a, b)
    flat = params_from_numpy(params_np, device="cpu")
    assert list(flat) == ["l0.b", "l0.w", "l1.b", "l1.w", "l2.b", "l2.w"]
    assert set(dict(MLP(D_IN, N_CLS, HIDDEN).named_parameters())) == set(flat)
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(flat)),
                    jax.tree_util.tree_leaves(params_np)):
        np.testing.assert_array_equal(a, b)


def test_later_slices_and_missing_cuda_raise():
    """Compressed gossip has landed: a compressing schedule over a state
    without error-feedback memory raises as the reference does, a
    schedule refuses what is not a CompressionSpec, and ``init`` gives no
    memory to an operand that carries no spec (the compressed round itself
    is tested in ``tests/test_torch_compressed_depositum.py``)."""
    from repro_torch.core import CompressionSpec

    params_np, state_np, batches = _problem()
    st = state_from_numpy(state_np, device="cpu")
    bt = {k: torch.from_numpy(v[0]) for k, v in batches.items()}
    sched = TSchedule.constant(TPlan.dense(mixing_matrix("ring", C),
                                           device="cpu"))
    with pytest.raises(ValueError, match="error-feedback memory"):
        tdep.step(st._replace(t=T0 - 1), bt, _t_grad_fn(),
                  tdep.DepositumConfig(**_cfg()), sched.with_compression(
                      CompressionSpec.topk(0.5, device="cpu")))
    with pytest.raises(TypeError, match="CompressionSpec"):
        sched.with_compression(object())
    assert tdep.init(params_from_numpy(params_np, device="cpu"), C,
                     compress=object(), device="cpu").comm == ()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            tdep.init(params_from_numpy(params_np, device="cpu"), C)


@pytest.mark.parametrize("fused", ["off", "require"])
def test_round_divides_by_scalars_on_the_state_device(fused, monkeypatch):
    """Every step of a round gets its Hyper as 0-d views of the one (5,)
    row on the state's device (so the unfused prox divides tensor by
    tensor on the card), and the unfused round still matches the
    reference at TOL."""
    _, state_np, batches = _problem()
    W = mixing_matrix("ring", C)
    kw = _cfg(fused=fused)
    seen = []
    step = tdep._step

    def spy(state, batch, grad_fn, config, mixer, is_comm, hp, hp_vec,
            mask):
        seen.append((hp, hp_vec))
        return step(state, batch, grad_fn, config, mixer, is_comm, hp,
                    hp_vec, mask)

    monkeypatch.setattr(tdep, "_step", spy)
    st = state_from_numpy(state_np, device="cpu")
    ts, _ = tdep.local_then_comm_round(
        st, {k: torch.from_numpy(v) for k, v in batches.items()},
        _t_grad_fn(), tdep.DepositumConfig(**kw),
        TPlan.dense(W, device="cpu"))
    assert len(seen) == T0
    hp, vec = seen[0]
    assert all(h is hp and v is vec for h, v in seen)      # once a round
    assert vec.shape == (5,) and vec.device == st.x["l0.w"].device
    host = tdep.DepositumConfig(**kw).hyper()
    for name, col in (("lam", 0), ("theta", 1), ("alpha", 2), ("gamma", 3),
                      ("beta", 4)):
        leaf = getattr(hp, name)
        assert leaf.ndim == 0 and leaf.device == vec.device
        assert leaf.untyped_storage().data_ptr() == \
            vec.untyped_storage().data_ptr()
        assert float(leaf) == float(vec[col]) == float(getattr(host, name))
    j_round = jax.jit(functools.partial(
        jdep.local_then_comm_round, grad_fn=_j_grad_fn(),
        config=jdep.DepositumConfig(**kw), mixer=JPlan.dense(W)))
    js, _ = j_round(_j_state(state_np),
                    {k: jnp.asarray(v) for k, v in batches.items()})
    _assert_state_close(ts, js)
