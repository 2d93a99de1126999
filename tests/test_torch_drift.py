"""The sweep-vs-sequential drift of a Fig. 6 grid: the port's against the
reference's own.

On the card a Fig. 6 sweep's y, nu and g end ~5e-2 (relative L2) from the
same grid run one config at a time, x ~6e-3, after 800 steps.  Whether
that is a fault is settled by running the grid on the same weights and
batches through the reference's ``sweep_run`` (vmap) and
``sweep_run_sequential`` (one config a program), the port's ``sweep_run``
((S, C, ...) leaves) and ``sweep_run_sequential``, and, as the yardstick,
the reference's ``sweep_run`` again with every initial weight nudged one
ulp up: how far this nonconvex run carries a one-ulp difference.

The test runs a reduced grid (the published widths, 4 rounds of T0 20 =
80 steps): every run differs from every other by no more than the nudged
reference differs from its own run (field by field, relative L2).  Run as
a script for the full 40 rounds (800 steps; ~3 min on the CPU), which
prints the table:

    PYTHONPATH=src python tests/test_torch_drift.py [--rounds 40]
"""
import argparse
import dataclasses
import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

FIELDS = ("x", "y", "nu", "g")
YARDSTICK = "ref_sweep_nudged vs ref_sweep"


def _rel(a: dict, b: dict) -> dict:
    """Relative L2 of each field over the whole tree (all leaves)."""
    out = {}
    for f in FIELDS:
        num = sum(float(np.sum((np.asarray(u, np.float64)
                                - np.asarray(v, np.float64)) ** 2))
                  for u, v in zip(a[f], b[f]))
        den = sum(float(np.sum(np.asarray(v, np.float64) ** 2))
                  for v in b[f])
        out[f] = (num / max(den, 1e-300)) ** 0.5
    return out


def five_runs(rounds: int) -> dict:
    """Final states (field -> list of (S, C, ...) arrays in the reference's
    leaf order) of the five runs of the Fig. 6 grid at ``rounds``."""
    from benchmarks.common import apply_mlp, ce_loss, init_mlp
    from benchmarks.fig6_topology import configs as j_configs
    from repro.core import MixPlan as JPlan
    from repro.core import stack_hypers as j_stack
    from repro.core import stack_mixplans as j_stack_plans
    from repro.data import make_classification
    from repro.training.sweep import sweep_run as j_sweep
    from repro.training.sweep import sweep_run_sequential as j_seq
    from repro_torch.convert import params_from_numpy
    from repro_torch.figures import fig6_configs
    from repro_torch.quickstart import grid_operands
    from repro_torch.training.sweep import sweep_run, sweep_run_sequential

    jcfgs = [dataclasses.replace(c, rounds=rounds) for c in j_configs()]
    cfg0 = jcfgs[0]
    ds = make_classification(n_samples=cfg0.n_samples,
                             n_features=cfg0.n_features,
                             n_classes=cfg0.n_classes,
                             n_clients=cfg0.n_clients, theta=cfg0.theta,
                             seed=cfg0.seed)
    params0 = init_mlp(jax.random.PRNGKey(cfg0.seed), cfg0.n_features,
                       cfg0.n_classes)
    rng = np.random.default_rng(cfg0.seed + 7)
    draws = [ds.stacked_batches(rng, cfg0.batch, cfg0.depositum.comm_period)
             for _ in range(rounds)]
    bx = np.stack([d[0] for d in draws])
    by = np.stack([d[1] for d in draws])
    grad_one = jax.grad(functools.partial(ce_loss, apply_mlp))
    grad_fn = lambda x, b: (jax.vmap(grad_one)(x, b), {})
    plan = j_stack_plans([JPlan.from_topology(c.topology, c.n_clients)
                          for c in jcfgs])
    hypers = j_stack([c.depositum.hyper() for c in jcfgs])
    jb = {"x": jnp.asarray(bx), "y": jnp.asarray(by)}
    nudged = jax.tree_util.tree_map(
        lambda v: jnp.asarray(np.nextafter(np.asarray(v), np.float32(np.inf))),
        params0)
    runs = {}
    for name, fn, p in (("ref_sweep", j_sweep, params0),
                        ("ref_sequential", j_seq, params0),
                        ("ref_sweep_nudged", j_sweep, nudged)):
        final, _ = fn(p, grad_fn, cfg0.depositum, plan, hypers, jb,
                      n_clients=cfg0.n_clients)
        runs[name] = {f: [np.asarray(v) for v in
                          jax.tree_util.tree_leaves(getattr(final, f))]
                      for f in FIELDS}

    cfgs = fig6_configs(rounds)
    p0 = params_from_numpy(jax.tree_util.tree_map(np.asarray, params0),
                           device="cpu")
    g = grid_operands(cfgs, params0=p0, device="cpu")
    assert np.array_equal(g.batches["x"].numpy(), bx)
    for name, fn in (("port_sweep", sweep_run),
                     ("port_sequential", sweep_run_sequential)):
        final, _ = fn(g.params0, g.prepared.grad_fn, cfgs[0].depositum,
                      g.plan, g.hypers, g.batches, n_clients=cfgs[0].n_clients)
        # the port's flat names sort like the reference's nested leaves
        runs[name] = {f: [getattr(final, f)[k].numpy()
                          for k in sorted(getattr(final, f))]
                      for f in FIELDS}
    return runs


def drift_table(runs: dict) -> dict:
    pairs = (("ref_sweep_nudged", "ref_sweep"),
             ("ref_sweep", "ref_sequential"),
             ("port_sweep", "port_sequential"),
             ("port_sweep", "ref_sweep"),
             ("port_sequential", "ref_sequential"))
    return {f"{a} vs {b}": _rel(runs[a], runs[b]) for a, b in pairs}


def test_port_sweep_drifts_no_more_than_the_reference_from_itself():
    torch.set_num_threads(2)
    table = drift_table(five_runs(rounds=4))
    bound = table[YARDSTICK]
    for pair, rel in table.items():
        for f in FIELDS:
            assert rel[f] <= bound[f], (pair, f, table)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=40)
    args = ap.parse_args(argv)
    table = drift_table(five_runs(args.rounds))
    print(json.dumps({"rounds": args.rounds, "relative_l2": table},
                     indent=1))
    return 0


if __name__ == "__main__":
    __import__("os").environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve()
                           .parents[1]))
    sys.exit(main())
