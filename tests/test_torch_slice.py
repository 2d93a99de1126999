"""Port parity for the slice as a whole: MLP rounds end to end.

The port's ``run_depositum`` (fused kernels on: their plain versions on the
CPU) against the reference's round program (Pallas kernels in interpret
mode) driven the way ``benchmarks/common.py::run_depositum`` drives it, on
the same data, batches and initial weights.  Trajectories are held by
tolerance only (rtol = 1e-4): the reference is not bit-exact against
itself across paths, and the two sum gradients and mixes in another order.
Also: the package's import rules and the entry points' device contract.
"""
import functools
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import apply_mlp, ce_loss as j_ce, init_mlp
from repro.core import (DepositumConfig as JConfig, init as j_init,
                        local_then_comm_round, make_dense_mixer,
                        mixing_matrix, stationarity_metrics)
from repro.data import make_classification
from repro_torch.convert import params_from_numpy, state_to_numpy
from repro_torch.core import DepositumConfig as TConfig
from repro_torch.quickstart import ExperimentConfig, run_depositum

ROOT = Path(__file__).resolve().parents[1]
ROUNDS, C, D, K, HIDDEN, T0, BATCH, N = 5, 4, 12, 5, (16, 8), 3, 8, 240
DEP = dict(alpha=0.05, beta=0.5, gamma=0.8, momentum="polyak",
           comm_period=T0, prox_name="mcp",
           prox_kwargs={"lam": 1e-3, "theta": 4.0}, fused="require")
METRICS = ("prox_grad_sq", "consensus_x", "consensus_y", "consensus_nu",
           "grad_est_err", "stationarity")


def _reference(params0):
    """The reference's sequential harness at the small size."""
    ds = make_classification(n_samples=N, n_features=D, n_classes=K,
                              n_clients=C, theta=1.0, seed=0)
    loss_one = functools.partial(j_ce, apply_mlp)
    grad_one = jax.grad(loss_one)
    grad_fn = lambda xs, b: (jax.vmap(grad_one)(xs, b), {})
    xs = jnp.asarray(np.stack([ds.client_arrays(i)[0] for i in range(C)]))
    ys = jnp.asarray(np.stack([ds.client_arrays(i)[1] for i in range(C)]))
    all_x, all_y = xs.reshape(-1, D), ys.reshape(-1)
    grad_fns = {
        "local_at": lambda x: jax.vmap(grad_one)(x, {"x": xs, "y": ys}),
        "global_at": lambda x: jax.vmap(lambda p: grad_one(
            p, {"x": all_x, "y": all_y}))(x)}
    cfg = JConfig(**DEP)
    rnd = jax.jit(functools.partial(
        local_then_comm_round, grad_fn=grad_fn, config=cfg,
        mixer=make_dense_mixer(mixing_matrix("ring", C))))
    metrics = jax.jit(functools.partial(stationarity_metrics,
                                        grad_fns=grad_fns, config=cfg))
    state = j_init(params0, C)
    rng = np.random.default_rng(7)
    curves = {k: [] for k in ("loss", "accuracy") + METRICS}
    for _ in range(ROUNDS):
        bx, by = ds.stacked_batches(rng, BATCH, T0)
        state, _ = rnd(state, {"x": jnp.asarray(bx), "y": jnp.asarray(by)})
        m = metrics(state)
        pbar = jax.tree_util.tree_map(lambda v: jnp.mean(v, 0), state.x)
        curves["loss"].append(float(loss_one(pbar, {"x": all_x,
                                                    "y": all_y})))
        curves["accuracy"].append(float(jnp.mean(
            jnp.argmax(apply_mlp(pbar, all_x), -1) == all_y)))
        for k in METRICS:
            curves[k].append(float(m[k]))
    return state, curves


def test_mlp_rounds_end_to_end_match_reference():
    params0 = init_mlp(jax.random.PRNGKey(0), D, K, hidden=HIDDEN)
    js, jc = _reference(params0)
    cfg = ExperimentConfig(model="mlp", n_clients=C, topology="ring",
                           theta=1.0, rounds=ROUNDS, batch=BATCH,
                           n_features=D, n_classes=K, n_samples=N, seed=0,
                           hidden=HIDDEN, depositum=TConfig(**DEP))
    p0 = params_from_numpy(jax.tree_util.tree_map(np.asarray, params0),
                           device="cpu")
    ts, tc = run_depositum(cfg, metrics_every=1, params0=p0, device="cpu")
    assert tc["round"] == list(range(1, ROUNDS + 1))
    for k in jc:
        np.testing.assert_allclose(tc[k], jc[k], rtol=1e-4, err_msg=k)
    assert tc["stationarity"][-1] < tc["stationarity"][0]
    tn = state_to_numpy(ts)
    for f in ("x", "y", "nu", "g"):
        for a, b in zip(jax.tree_util.tree_leaves(tn[f]),
                        jax.tree_util.tree_leaves(getattr(js, f))):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4,
                                       atol=1e-6, err_msg=f)
    assert int(tn["t"]) == int(js.t) == ROUNDS * T0


def test_port_imports_neither_jax_nor_the_reference():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="is_available"):
        run_depositum(ExperimentConfig(rounds=1))
    from repro_torch.quickstart import main
    with pytest.raises(RuntimeError, match="is_available"):
        main(["--rounds", "1"])


def test_chip_smoke_fails_without_cuda_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120,
                          cwd=ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_profile_round_breaks_a_round_into_phases():
    from repro_torch.profile_round import profile_rounds
    out = profile_rounds("require", rounds=1, warmup=1, device="cpu")
    phases = out["host_phase_ms_per_round"]
    assert set(phases) == {"fused_kernel", "local_step", "gossip", "other"}
    assert phases["fused_kernel"] > 0 and phases["local_step"] == 0
    assert out["wall_ms_per_round"] > phases["fused_kernel"]
