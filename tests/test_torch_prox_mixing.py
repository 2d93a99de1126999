"""Port parity: hyperparameters, prox families, momentum and mixing.

Tolerances: the prox maps and the momentum axpy are the same fp32
operations in the same order on both sides, held at rtol = 1e-6 (1 ulp
scale; XLA may contract a multiply-add).  Mixing sums over clients in
another order (XLA's einsum vs a PyTorch matmul), held at atol = 1e-6.
Host-side range checks must raise before any compute on both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import depositum as jdep
from repro.core import hyper as jhyp
from repro.core import mixing as jmix
from repro.core import momentum as jmom
from repro.core import prox as jprox
from repro.core.gossip import make_dense_mixer as j_dense_mixer
from repro.core.topology import mixing_matrix
from repro_torch.core import depositum as tdep
from repro_torch.core import hyper as thyp
from repro_torch.core import mixing as tmix
from repro_torch.core import momentum as tmom
from repro_torch.core import prox as tprox
from repro_torch.core.gossip import make_dense_mixer as t_dense_mixer

RTOL, ATOL_ELEM = 1e-6, 1e-7
ATOL_MIX = 1e-6
FAMILIES = ["l1", "l2sq", "box", "group_l2", "mcp", "scad", "zero"]


def _arr(seed, shape, scale=0.05):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("shape", [(37,), (6, 5)])
def test_prox_family_matches_reference(name, shape):
    x = _arr(hash((name, shape)) % 2**31, shape)
    alpha, lam, theta = 0.1, 0.02, 3.7
    ja, jl, jt = (jnp.float32(v) for v in (alpha, lam, theta))
    ta, tl, tt = (torch.tensor(v, dtype=torch.float32)
                  for v in (alpha, lam, theta))
    jf, tf = jprox.get_family(name), tprox.get_family(name)
    np.testing.assert_allclose(
        _np(tf.prox_fn(torch.from_numpy(x), ta, tl, tt)),
        np.asarray(jf.prox_fn(jnp.asarray(x), ja, jl, jt)),
        rtol=RTOL, atol=ATOL_ELEM)
    np.testing.assert_allclose(
        _np(tf.value({"a": torch.from_numpy(x)}, tl, tt)),
        np.asarray(jf.value({"a": jnp.asarray(x)}, jl, jt)),
        rtol=RTOL, atol=ATOL_ELEM)


@pytest.mark.parametrize("name,kw", [
    ("l1", {"lam": 0.01}), ("l2sq", {"lam": 0.3}), ("box", {"radius": 0.04}),
    ("group_l2", {"lam": 0.05}), ("mcp", {"lam": 0.02, "theta": 3.0}),
    ("scad", {"lam": 0.02, "theta": 3.7}), ("zero", {})])
def test_bound_operator_and_prox_gradient_match(name, kw):
    x, g = _arr(1, (5, 7)), _arr(2, (5, 7))
    jo, to = jprox.get_prox(name, **kw), tprox.get_prox(name, **kw)
    assert jo.name == to.name
    assert float(jo.weak_convexity) == pytest.approx(float(to.weak_convexity))
    jG = jprox.prox_gradient(jo, {"w": jnp.asarray(x)}, {"w": jnp.asarray(g)},
                             0.2)
    tG = tprox.prox_gradient(to, {"w": torch.from_numpy(x)},
                             {"w": torch.from_numpy(g)}, 0.2)
    np.testing.assert_allclose(_np(tG["w"]), np.asarray(jG["w"]),
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(_np(to.value({"w": torch.from_numpy(x)})),
                               np.asarray(jo.value({"w": jnp.asarray(x)})),
                               rtol=RTOL, atol=ATOL_ELEM)


@pytest.mark.parametrize("kind", ["none", "polyak", "nesterov"])
@pytest.mark.parametrize("gamma", [0.0, 0.8])
def test_momentum_update_matches(kind, gamma):
    nu, mu, y = (_arr(s, (4, 9)) for s in (3, 4, 5))
    jn, jm = jmom.momentum_update(kind, jnp.float32(gamma),
                                  {"a": jnp.asarray(nu)},
                                  {"a": jnp.asarray(mu)},
                                  {"a": jnp.asarray(y)})
    tn, tm = tmom.momentum_update(kind, torch.tensor(gamma),
                                  {"a": torch.from_numpy(nu)},
                                  {"a": torch.from_numpy(mu)},
                                  {"a": torch.from_numpy(y)})
    np.testing.assert_allclose(_np(tn["a"]), np.asarray(jn["a"]), rtol=RTOL,
                               atol=ATOL_ELEM)
    np.testing.assert_allclose(_np(tm["a"]), np.asarray(jm["a"]), rtol=RTOL,
                               atol=ATOL_ELEM)


def test_hyper_grid_matches():
    jg = jhyp.hyper_grid(alpha=[0.05, 0.1], gamma=[0.0, 0.5, 0.8])
    tg = thyp.hyper_grid(alpha=[0.05, 0.1], gamma=[0.0, 0.5, 0.8])
    assert jhyp.n_sweep(jg) == thyp.n_sweep(tg) == 6
    for f in jhyp.Hyper._fields:
        np.testing.assert_array_equal(_np(getattr(tg, f)),
                                      np.asarray(getattr(jg, f)))
    assert thyp.n_sweep(thyp.Hyper.create()) == 1
    with pytest.raises(ValueError):
        thyp.stack_hypers([])


def _plans(n):
    W = mixing_matrix("ring", n)
    Wt = mixing_matrix("torus", n)
    ring = [(+1, 1 / 3), (-1, 1 / 3)]
    j = {"dense": jmix.MixPlan.dense(Wt),
         "circulant": jmix.MixPlan.circulant(ring, 1 / 3),
         "complete": jmix.MixPlan.complete(),
         "identity": jmix.MixPlan.identity(),
         "chebyshev_dense": jmix.MixPlan.chebyshev(jmix.MixPlan.dense(W), 3),
         "chebyshev_circulant": jmix.MixPlan.chebyshev(
             jmix.MixPlan.circulant(ring, 1 / 3), 2, n=n)}
    t = {"dense": tmix.MixPlan.dense(Wt, device="cpu"),
         "circulant": tmix.MixPlan.circulant(ring, 1 / 3, device="cpu"),
         "complete": tmix.MixPlan.complete(),
         "identity": tmix.MixPlan.identity(),
         "chebyshev_dense": tmix.MixPlan.chebyshev(
             tmix.MixPlan.dense(W, device="cpu"), 3),
         "chebyshev_circulant": tmix.MixPlan.chebyshev(
             tmix.MixPlan.circulant(ring, 1 / 3, device="cpu"), 2, n=n)}
    return j, t


@pytest.mark.parametrize("kind", ["dense", "circulant", "complete",
                                  "identity", "chebyshev_dense",
                                  "chebyshev_circulant"])
def test_apply_mix_and_plan_queries_match(kind):
    n = 6
    jp, tp = (p[kind] for p in _plans(n))
    tree = {"a": _arr(7, (n, 3, 4), 1.0), "b": _arr(8, (n,), 1.0)}
    jo = jmix.apply_mix(jp, {k: jnp.asarray(v) for k, v in tree.items()})
    to = tmix.apply_mix(tp, {k: torch.from_numpy(v) for k, v in tree.items()})
    for k in tree:
        np.testing.assert_allclose(_np(to[k]), np.asarray(jo[k]),
                                   atol=ATOL_MIX, rtol=0)
    np.testing.assert_allclose(
        _np(tmix.as_dense(tp, n, device="cpu").W),
        np.asarray(jmix.as_dense(jp, n).W), atol=ATOL_MIX, rtol=0)
    np.testing.assert_allclose(tmix.plan_spectral_lambda(tp, n),
                               jmix.plan_spectral_lambda(jp, n), atol=1e-6)
    tmix.validate_plan(tp, n)
    jmix.validate_plan(jp, n)


def test_stacked_plans_and_dense_mixer_match():
    n = 5
    Ws = [mixing_matrix(t, n) for t in ("ring", "star", "complete")]
    js = jmix.stack_mixplans([jmix.MixPlan.dense(W) for W in Ws])
    ts = tmix.stack_mixplans([tmix.MixPlan.dense(W, device="cpu")
                              for W in Ws])
    assert ts.is_stacked and ts.n_sweep == js.n_sweep == 3
    np.testing.assert_allclose(tmix.plan_spectral_lambda(ts, n),
                               jmix.plan_spectral_lambda(js, n), atol=1e-6)
    x = _arr(9, (n, 11), 1.0)
    for s in range(3):
        jo = jmix.apply_mix(js.point(s), {"a": jnp.asarray(x)})["a"]
        to = tmix.apply_mix(ts.point(s), {"a": torch.from_numpy(x)})["a"]
        np.testing.assert_allclose(_np(to), np.asarray(jo), atol=ATOL_MIX)
    with pytest.raises(ValueError):
        tmix.stack_mixplans([tmix.MixPlan.complete()] * 2)
    with pytest.raises(ValueError):
        tmix.apply_mix(ts, {"a": torch.from_numpy(x)})
    jo = j_dense_mixer(Ws[1])({"a": jnp.asarray(x)})["a"]
    to = t_dense_mixer(Ws[1], device="cpu")({"a": torch.from_numpy(x)})["a"]
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=ATOL_MIX)


@pytest.mark.parametrize("kw", [
    dict(alpha=0.5, prox_name="mcp", prox_kwargs={"lam": 1e-3,
                                                  "theta": 0.4}),  # a*rho>=1
    dict(alpha=0.6, prox_name="scad", prox_kwargs={"lam": 1e-3,
                                                   "theta": 1.5}),  # theta<=2
    dict(gamma=1.0),                                               # gamma
    dict(gamma=-0.1),
    dict(comm_period=0),
    dict(fused="sometimes"),
])
def test_range_checks_raise_host_side_alike(kw):
    with pytest.raises(ValueError):
        jdep.DepositumConfig(**kw).validate()
    with pytest.raises(ValueError):
        tdep.DepositumConfig(**kw).validate()


def test_stacked_hyper_range_checks_alike():
    cfg_kw = dict(prox_name="mcp", prox_kwargs={"lam": 1e-3, "theta": 4.0})
    bad = dict(alpha=[0.05, 4.5])          # alpha * (1/theta) >= 1 at point 2
    jg = jhyp.hyper_grid(jdep.DepositumConfig(**cfg_kw).hyper(), **bad)
    tg = thyp.hyper_grid(tdep.DepositumConfig(**cfg_kw).hyper(), **bad)
    with pytest.raises(ValueError):
        jdep.DepositumConfig(**cfg_kw).validate(jg)
    with pytest.raises(ValueError):
        tdep.DepositumConfig(**cfg_kw).validate(tg)
    ok = dict(gamma=[0.0, 0.9])
    jdep.DepositumConfig(**cfg_kw).validate(jhyp.hyper_grid(**ok))
    tdep.DepositumConfig(**cfg_kw).validate(thyp.hyper_grid(**ok))
