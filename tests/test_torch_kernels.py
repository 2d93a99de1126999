"""Port parity: the prox kernels' plain versions and their wrappers.

On the CPU each wrapper runs its kernel's plain PyTorch version; it is held
against the reference's Pallas kernels (interpret mode, as
``tests/test_fused_sweep.py`` runs them) and the ``ref.py`` oracle at
atol = rtol = 1e-6: the same fp32 operations, though XLA may contract a
multiply-add.  Frozen rows of the cohort gate must come back bit for bit.
The one-config kernels (``prox_cuda``, ``fused_update_cuda``) are held
against ``prox_pallas`` / ``fused_update_pallas`` at the reference's own
``tests/test_kernels.py`` tolerances: 1e-6 in fp32, 1.5e-2 in bf16.
The CUDA kernels themselves are held to the plain versions by
``tests/test_torch_kernels_gpu.py``, which skips without a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.prox import ops as jops
from repro.kernels.prox.kernel import (
    fused_tracking_sweep_pallas,
    fused_update_pallas,
    fused_update_sweep_pallas,
    prox_pallas,
    sweep_params_table as j_table,
)
from repro.kernels.prox.ref import fused_update_ref as j_ref
from repro_torch.kernels.prox import kernel as tk
from repro_torch.kernels.prox import ops as tops
from repro_torch.kernels.prox.ref import fused_update_ref as t_ref

S, C = 3, 4
TOL = dict(atol=1e-6, rtol=1e-6)
KINDS = ["l1", "mcp", "scad"]
SHAPES = [(), (777,), (5, 33)]
TABLE = dict(lam=[1e-3, 5e-3, 1e-2], theta=4.0, alpha=[0.05, 0.1, 0.2],
             gamma=[0.0, 0.5, 0.9], beta=[1.0, 0.5, 1.5])
MASK = np.array([[1, 0, 1, 0], [0, 0, 0, 0], [1, 1, 0, 1]], np.float32)


def _make(seed, shape, n=3):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((S, C) + shape) * 0.1).astype(np.float32)
            for _ in range(n)]


def _tables():
    jt = j_table(**{k: jnp.asarray(v) for k, v in TABLE.items()})
    tt = tk.sweep_params_table(**TABLE, device="cpu")
    return jt, tt


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(a):
    return np.asarray(a).view(np.int32)


def test_params_table_matches():
    jt, tt = _tables()
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tk.PARAM_COLS == ("lam", "theta", "alpha", "gamma", "beta")
    one = tk.sweep_params_table(1e-4, 4.0, 0.05, 0.8, 0.5, device="cpu")
    assert one.shape == (1, 5) and one.dtype == torch.float32


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_update_plain_matches_pallas_and_oracle(kind, shape):
    x, y, nu = _make(10 * KINDS.index(kind) + SHAPES.index(shape), shape)
    jt, tt = _tables()
    jx, jn = fused_update_sweep_pallas(jnp.asarray(x), jnp.asarray(y),
                                       jnp.asarray(nu), jt, kind=kind)
    tx, tn = tk.fused_update_sweep_cuda(_t(x), _t(y), _t(nu), tt, kind=kind)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), **TOL)
    for s in range(S):  # the oracle, row s of the table on slice s
        lam, theta, alpha, gamma, _ = (float(v) for v in tt[s])
        rx, rn = t_ref(_t(x[s]), _t(y[s]), _t(nu[s]), lam, alpha, gamma,
                       prox_kind=kind, theta=theta)
        ox, on = j_ref(jnp.asarray(x[s]), jnp.asarray(y[s]),
                       jnp.asarray(nu[s]), lam, alpha, gamma,
                       prox_kind=kind, theta=theta)
        np.testing.assert_allclose(tx[s].numpy(), rx.numpy(), **TOL)
        np.testing.assert_allclose(tn[s].numpy(), rn.numpy(), **TOL)
        np.testing.assert_allclose(rx.numpy(), np.asarray(ox), **TOL)


@pytest.mark.parametrize("kind", ["l1", "mcp", "scad"])
def test_update_gate_freezes_rows_bit_exact(kind):
    x, y, nu = _make(11, (333,))
    jt, tt = _tables()
    jx, jn = fused_update_sweep_pallas(jnp.asarray(x), jnp.asarray(y),
                                       jnp.asarray(nu), jt,
                                       jnp.asarray(MASK), kind=kind)
    tx, tn = tk.fused_update_sweep_cuda(_t(x), _t(y), _t(nu), tt,
                                        _t(MASK), kind=kind)
    for s in range(S):
        for c in range(C):
            if MASK[s, c] > 0:
                np.testing.assert_allclose(tx[s, c].numpy(),
                                           np.asarray(jx[s, c]), **TOL)
                np.testing.assert_allclose(tn[s, c].numpy(),
                                           np.asarray(jn[s, c]), **TOL)
            else:
                np.testing.assert_array_equal(_bits(tx[s, c]), _bits(x[s, c]))
                np.testing.assert_array_equal(_bits(tn[s, c]),
                                              _bits(nu[s, c]))


@pytest.mark.parametrize("shape,gated", [((257,), False), ((), True),
                                         ((4, 8), True)])
def test_tracking_plain_matches_pallas(shape, gated):
    y, gn, go = _make(21, shape)
    jt, tt = _tables()
    jm, tm = (jnp.asarray(MASK), _t(MASK)) if gated else (None, None)
    jy, jg = fused_tracking_sweep_pallas(jnp.asarray(y), jnp.asarray(gn),
                                         jnp.asarray(go), jt, jm)
    ty, tg = tk.fused_tracking_sweep_cuda(_t(y), _t(gn), _t(go), tt, tm)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_array_equal(_bits(tg), _bits(jg))
    if gated:
        for s in range(S):
            for c in range(C):
                if MASK[s, c] <= 0:
                    np.testing.assert_array_equal(_bits(ty[s, c]),
                                                  _bits(y[s, c]))
                    np.testing.assert_array_equal(_bits(tg[s, c]),
                                                  _bits(go[s, c]))


def test_bf16_storage_computes_in_fp32():
    x, y, nu = (torch.from_numpy(a).to(torch.bfloat16)
                for a in _make(4, (50,)))
    _, tt = _tables()
    tx, tn = tk.fused_update_sweep_cuda(x, y, nu, tt, kind="mcp")
    rx, rn = t_ref(x.float(), y.float(), nu.float(), tt[:, 0:1, None],
                   tt[:, 2:3, None], tt[:, 3:4, None], prox_kind="mcp",
                   theta=tt[:, 1:2, None])
    assert tx.dtype == tn.dtype == torch.bfloat16
    assert torch.equal(tx, rx.to(torch.bfloat16))
    assert torch.equal(tn, rn.to(torch.bfloat16))


@pytest.mark.parametrize("kind,gated", [("l1", True), ("scad", False)])
def test_round_entry_points_match_reference_ops(kind, gated):
    """ops.fused_local_update / fused_tracking (S = 1) on dicts of leaves."""
    rng = np.random.default_rng(5)
    shapes = {"l0.w": (C, 12, 16), "l0.b": (C, 16), "s": (C,)}
    trees = [{k: (rng.standard_normal(s) * 0.1).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    hp = dict(lam=2e-3, theta=4.0, alpha=0.1, gamma=0.7, beta=0.9)
    jvec = jnp.asarray([hp[k] for k in tk.PARAM_COLS], jnp.float32)
    tvec = torch.tensor([hp[k] for k in tk.PARAM_COLS])
    mask = np.array([1, 0, 1, 1], np.float32) if gated else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else _t(mask)
    jt = [{k: jnp.asarray(v) for k, v in t.items()} for t in trees]
    tt = [{k: _t(v) for k, v in t.items()} for t in trees]
    jx, jn = jops.fused_local_update(*jt, jvec, jm, kind=kind)
    tx, tn = tops.fused_local_update(*tt, tvec, tm, kind=kind)
    jy, jg = jops.fused_tracking(*jt, jvec, jm)
    ty, tg = tops.fused_tracking(*tt, tvec, tm)
    for k in shapes:
        for a, b in ((tx, jx), (tn, jn), (ty, jy)):
            assert a[k].shape == tuple(b[k].shape)
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]), **TOL)
        np.testing.assert_array_equal(_bits(tg[k]), _bits(jg[k]))


def test_hyper_param_vec_matches():
    from repro.core.hyper import Hyper as JHyper
    from repro_torch.core.hyper import Hyper as THyper
    kw = dict(alpha=0.05, beta=0.5, gamma=0.8, lam=1e-4, theta=4.0)
    np.testing.assert_array_equal(
        tops.hyper_param_vec(THyper.create(**kw)).numpy(),
        np.asarray(jops.hyper_param_vec(JHyper.create(**kw))))


def test_wrappers_check_their_inputs():
    x, y, nu = (_t(a) for a in _make(3, (10,)))
    _, tt = _tables()
    with pytest.raises(ValueError, match="no kernel for device"):
        tk.fused_update_sweep_cuda(x.to("meta"), y.to("meta"),
                                   nu.to("meta"), tt.to("meta"))
    with pytest.raises(ValueError, match="contiguous"):
        tk.fused_update_sweep_cuda(x.transpose(0, 1), y.transpose(0, 1),
                                   nu.transpose(0, 1), tt[:C])
    with pytest.raises(TypeError):
        tk.fused_tracking_sweep_cuda(x.double(), y.double(), nu.double(), tt)
    with pytest.raises(ValueError, match="params"):
        tk.fused_tracking_sweep_cuda(x, y, nu, tt[:2])
    with pytest.raises(ValueError, match="mask"):
        tk.fused_update_sweep_cuda(x, y, nu, tt, torch.ones(S, C + 1))
    with pytest.raises(ValueError, match="kind"):
        tk.fused_update_sweep_cuda(x, y, nu, tt, kind="box")
    assert tk.LAUNCH_COUNTS["fused_sweep"] == 0  # the plain path never counts


# ---------------------------------------------------------------------------
# One-config kernels: standalone prox and fused update
# ---------------------------------------------------------------------------

ONE_SHAPES = [(64,), (1000,), (8, 333), (4, 128, 130)]
ONE_DTYPES = [torch.float32, torch.bfloat16]
_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _one_tol(dtype):
    return 1e-6 if dtype == torch.float32 else 1.5e-2


def _leaf(seed, shape, dtype):
    a = (np.random.default_rng(seed).standard_normal(shape) * 0.01
         ).astype(np.float32)
    return torch.from_numpy(a).to(dtype), jnp.asarray(a, _JDT[dtype])


def _assert_leaf(t, j, dtype):
    assert t.dtype == dtype and tuple(t.shape) == tuple(j.shape)
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=_one_tol(dtype), rtol=_one_tol(dtype))


@pytest.mark.parametrize("shape", ONE_SHAPES)
@pytest.mark.parametrize("dtype", ONE_DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_prox_plain_matches_pallas(kind, dtype, shape):
    t, j = _leaf(ONE_SHAPES.index(shape) + 7 * KINDS.index(kind), shape,
                 dtype)
    hp = dict(lam=1e-3, theta=4.0, alpha=0.1)
    out = tk.prox_cuda(t, kind=kind, **hp)
    _assert_leaf(out, prox_pallas(j, kind=kind, **hp), dtype)
    assert torch.equal(out, tk.prox_plain(t, kind=kind, **hp))


@pytest.mark.parametrize("shape", [(1000,), (4, 128, 130)])
@pytest.mark.parametrize("dtype", ONE_DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_fused_update_plain_matches_pallas(kind, dtype, shape):
    (tx, jx), (ty, jy), (tn, jn) = (
        _leaf(i + 3 * KINDS.index(kind), shape, dtype) for i in range(3))
    hp = dict(lam=1e-3, theta=4.0, alpha=0.1, gamma=0.8)
    xo, nuo = tk.fused_update_cuda(tx, ty, tn, kind=kind, **hp)
    jxo, jnuo = fused_update_pallas(jx, jy, jn, kind=kind, **hp)
    _assert_leaf(xo, jxo, dtype)
    _assert_leaf(nuo, jnuo, dtype)


def test_one_config_kernels_take_tensor_hyperparameters():
    """0-d tensors give the same result as floats (no rebuild, no readback)."""
    x, _ = _leaf(1, (5, 33), torch.float32)
    y, _ = _leaf(2, (5, 33), torch.float32)
    hp = dict(lam=2e-3, theta=3.5, alpha=0.2)
    as_t = {k: torch.tensor(v) for k, v in hp.items()}
    assert torch.equal(tk.prox_cuda(x, kind="scad", **hp),
                       tk.prox_cuda(x, kind="scad", **as_t))
    a = tk.fused_update_cuda(x, y, x, kind="mcp", gamma=0.5, **hp)
    b = tk.fused_update_cuda(x, y, x, kind="mcp", gamma=torch.tensor(0.5),
                             **as_t)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    row = tk.hyper_row(x, **as_t)
    assert row.shape == (1, 5) and row.dtype == torch.float32
    with pytest.raises(ValueError, match="kind"):
        tk.prox_cuda(x, kind="box")
    with pytest.raises(TypeError):
        tk.prox_cuda(x.double())
    with pytest.raises(ValueError, match="differ"):
        tk.fused_update_cuda(x, y[:2], x)
    assert tk.LAUNCH_COUNTS["prox"] == tk.LAUNCH_COUNTS["fused_update"] == 0


def test_prox_tree_and_fused_update_tree_match_reference():
    rng = np.random.default_rng(8)
    shapes = {"w": (8, 16), "b": (16,), "s": ()}
    trees = [{k: (rng.standard_normal(s) * 0.05).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    tt = [{k: torch.from_numpy(np.asarray(v)) for k, v in t.items()}
          for t in trees]
    jt = [{k: jnp.asarray(v) for k, v in t.items()} for t in trees]
    hp = dict(kind="mcp", lam=0.02, alpha=0.5, theta=4.0)
    got, want = tops.prox_tree(tt[0], **hp), jops.prox_tree(jt[0], **hp)
    assert set(got) == set(shapes)
    for k in shapes:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)
    (gx, gn) = tops.fused_update_tree(*tt, gamma=0.5, **hp)
    (wx, wn) = jops.fused_update_tree(*jt, gamma=0.5, **hp)
    for k in shapes:
        assert gx[k].shape == shapes[k]
        np.testing.assert_allclose(gx[k].numpy(), np.asarray(wx[k]), **TOL)
        np.testing.assert_allclose(gn[k].numpy(), np.asarray(wn[k]), **TOL)
