"""One rank of a gloo group for ``test_torch_distributed.py``.

    python tests/_torch_dist_worker.py SUITE RANK WORLD STORE OUT

joins a gloo group of WORLD CPU processes through a ``FileStore`` at
STORE, runs every case of SUITE on this rank's rows of the client axis and
writes ``OUT/SUITE_RANK.npz``: each case's arrays, this rank's rows of the
client axis (keys ``"s:..."`` hold a sweep's ``(S, rows, ...)`` block,
keys ``"r:..."`` a value every rank holds).  It imports torch, numpy and
``repro_torch`` only.  The problems are made here from numpy seeds, so
the parent process builds the reference's runs from the same functions.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

# the least-squares problem of the reference's test_distributed.py
D, M, T0, ROUNDS = 12, 16, 3, 5
DC = 32                     # the compressed cases' width
CFG = dict(alpha=0.05, beta=1.0, gamma=0.5, momentum="polyak",
           comm_period=T0, prox_name="l1", prox_kwargs={"lam": 1e-3})
TOPOS = ("complete", "ring", "star", "torus")


def lsq(n: int, d: int = D, seed: int = 0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, M, d)).astype(np.float32)
    b = np.einsum("nmd,d->nm", A, rng.standard_normal(d).astype(np.float32))
    return A, b


def spd(n: int = 8, d: int = 32, seed: int = 1):
    """The one-step problem: per-client SPD quadratics."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, d, d)).astype(np.float32)
    A = np.einsum("nij,nkj->nik", A, A) / d + 0.5 * np.eye(d, dtype=np.float32)
    b = rng.standard_normal((n, d)).astype(np.float32)
    return A, b


def mix_input(n: int, seed: int = 2):
    return np.random.default_rng(seed).standard_normal((n, 5, 3)).astype(
        np.float32)


def ring(n: int):
    return [(+1, 1 / 3), (-1, 1 / 3)], 1 / 3


# ---------------------------------------------------------------------------
# rank side
# ---------------------------------------------------------------------------

def _torch_setup():
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT / "src"))
    return torch


def _lsq_grad(torch, n, rows, d=D, seed=0):
    A, b = lsq(n, d, seed)
    A, b = torch.from_numpy(A[rows]), torch.from_numpy(b[rows])

    def grad_fn(x, batch):
        w = x["w"]
        r = torch.einsum("nmd,nd->nm", A, w) - b
        return {"w": torch.einsum("nmd,nm->nd", A, r) / M}, {}

    return grad_fn


def _run_rounds(torch, mixer, n, rows, backend, *, d=D, n_max=None,
                compress=None, rounds=ROUNDS):
    from repro_torch.core import DepositumConfig, init, local_then_comm_round
    cfg = DepositumConfig(**CFG)
    st = init({"w": torch.zeros(d)}, n, n_max=n_max, compress=compress,
              device="cpu", backend=backend)
    g = _lsq_grad(torch, n_max or n, rows, d)
    batches = {"z": torch.zeros((T0, 1))}
    for _ in range(rounds):
        st, _ = local_then_comm_round(st, batches, g, cfg, mixer)
    return st


def _state_out(out, name, st):
    for f in ("x", "y", "nu", "g"):
        out[f"{name}/{f}"] = getattr(st, f)["w"].numpy()


def suite_mix(torch, world):
    """shard_body of every kind, placement mixers, gossip mixers, every
    schedule kind, cohorts, compressed schedules, a DEPOSITUM step run,
    the metrics and the counted collective bytes."""
    from repro_torch.analysis.comm import device_wire_bytes
    from repro_torch.analysis.hlo import collective_bytes, counting
    from repro_torch.core import (CompressionSpec, MixPlan, MixSchedule,
                                  apply_mix)
    from repro_torch.core.depositum import (DepositumConfig, init, step,
                                            stationarity_metrics)
    from repro_torch.core.gossip import (make_complete_mixer, ring_mixer,
                                         torus_mixer)
    from repro_torch.core.topology import mixing_matrix
    from repro_torch.launch.gossip_dist import (make_shardmap_mixer,
                                                make_shardmap_ring_mixer,
                                                plan_for_topology)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import Placement, _RULES_REPLICATED
    from repro_torch.training.backends import get_backend

    out = {}
    mesh = make_host_mesh(world, 1)
    cpu = dict(device="cpu")

    def backend(n):
        return get_backend("shard_map", mesh=mesh, axis_name="data",
                           n_clients=n)

    # shard_body, every kind: n = world (one client a rank) and 2 x world
    for n in (world, 2 * world):
        be = backend(n)
        x = torch.from_numpy(mix_input(n))
        loc = {"w": x[be.rows]}
        plans = {"complete": MixPlan.complete(),
                 "identity": MixPlan.identity(),
                 "dense": MixPlan.dense(mixing_matrix("ring", n), **cpu),
                 "cheb_dense": MixPlan.chebyshev(
                     MixPlan.dense(mixing_matrix("ring", n), **cpu), 2)}
        if n == world:
            circ = MixPlan.circulant(*ring(n), **cpu)
            plans["circulant"] = circ
            plans["cheb_circulant"] = MixPlan.chebyshev(circ, 3, n=n)
        for name, plan in plans.items():
            got = be.mixer_for(plan)(loc)["w"]
            out[f"mix{n}/{name}"] = got.numpy()
            stacked = apply_mix(plan, {"w": x})["w"][be.rows]
            out[f"r:mixbits{n}/{name}"] = np.asarray(
                torch.equal(got, stacked))

    # the placement mixers (launch.gossip_dist) and the gossip mixers
    n = world
    be = backend(n)
    placement = Placement(mode="replicated", mesh=mesh,
                          clients_axes=("data",),
                          rules=dict(_RULES_REPLICATED))
    x = torch.from_numpy(mix_input(n, seed=3).reshape(n, 15))
    loc = {"w": x[be.rows]}
    axes, shapes = {"w": ("clients", "mlp")}, {"w": (n, 15)}
    for topo in TOPOS:
        mix = make_shardmap_mixer(placement, axes, shapes,
                                  plan_for_topology(topo, n, **cpu))
        out[f"place/{topo}"] = mix(loc)["w"].numpy()
    out["place/ring_adapter"] = make_shardmap_ring_mixer(
        placement, axes, shapes, "ring", **cpu)(loc)["w"].numpy()
    ax = mesh.axis("data")
    out["gossip/ring"] = ring_mixer(ax, n, **cpu)(loc)["w"].numpy()
    out["gossip/torus"] = torus_mixer(ax, n, **cpu)(loc)["w"].numpy()
    out["gossip/complete"] = make_complete_mixer(ax)(loc)["w"].numpy()

    # every schedule kind, 5 rounds of T0 = 3 through the backend
    for name, (n, sched) in schedules(torch, world).items():
        be = backend(n)
        st = _run_rounds(torch, be.mixer_for(sched), n, be.rows, be)
        _state_out(out, f"sched/{name}", st)
    # the constant schedule on the shard path: the static plan's rounds
    n = 2 * world
    be = backend(n)
    W = MixPlan.dense(mixing_matrix("ring", n), **cpu)
    a = _run_rounds(torch, be.mixer_for(MixSchedule.constant(W)), n,
                    be.rows, be)
    b = _run_rounds(torch, be.mixer_for(W), n, be.rows, be)
    out["r:const_bits"] = np.asarray(torch.equal(a.x["w"], b.x["w"]))

    # cohorts with the reference's masks injected (parent's file)
    masks = np.load(os.environ["DIST_COHORT_MASKS"])
    n_max = 2 * world
    be = backend(n_max)
    for name in ("full", "bernoulli", "fixed", "padded"):
        n_eff = 5 if name == "padded" else n_max
        sched = cohort_schedule(torch, name, n_max, torch.from_numpy(
            masks[name]))
        st = _run_rounds(torch, be.mixer_for(sched), n_eff, be.rows, be,
                         n_max=n_max if name == "padded" else None)
        _state_out(out, f"cohort/{name}", st)
    full = _run_rounds(torch, be.mixer_for(cohort_schedule(
        torch, "full", n_max, torch.from_numpy(masks["full"]))), n_max,
        be.rows, be)
    const = _run_rounds(torch, be.mixer_for(MixSchedule.constant(
        MixPlan.dense(mixing_matrix("ring", n_max), **cpu))), n_max,
        be.rows, be)
    out["r:full_cohort_bits"] = np.asarray(torch.equal(full.x["w"],
                                                       const.x["w"]))

    # compressed schedules: the packed wire path (uniforms injected)
    draws = np.load(os.environ["DIST_DRAWS"])
    for name, (n, sched) in compressed_schedules(torch, world,
                                                 draws).items():
        be = backend(n)
        mixer = be.mixer_for(sched)
        out[f"r:wire/{name}"] = np.asarray(mixer.wire_fn is not None)
        st = _run_rounds(torch, mixer, n, be.rows, be, d=DC, compress=sched)
        _state_out(out, f"comp/{name}", st)
    n = 2 * world
    be = backend(n)
    dense = MixSchedule.constant(MixPlan.dense(mixing_matrix("ring", n),
                                               **cpu))
    none = dense.with_compression(CompressionSpec.none(**cpu))
    a = _run_rounds(torch, be.mixer_for(none), n, be.rows, be, d=DC,
                    compress=none)
    b = _run_rounds(torch, be.mixer_for(dense), n, be.rows, be, d=DC)
    out["r:none_bits"] = np.asarray(torch.equal(a.x["w"], b.x["w"]))

    # one comm step and 5 DEPOSITUM steps (the reference's host test)
    n = 2 * world
    be = backend(n)
    A, bb = spd(n)
    A, bb = torch.from_numpy(A[be.rows]), torch.from_numpy(bb[be.rows])

    def grad_fn(x, batch):
        return {"w": torch.einsum("nij,nj->ni", A, x["w"]) - bb}, {}

    cfg = DepositumConfig(alpha=0.05, beta=1.0, gamma=0.5, comm_period=1,
                          prox_name="l1", prox_kwargs={"lam": 1e-3})
    mixer = be.mixer_for(MixPlan.dense(mixing_matrix("ring", n), **cpu))
    st = init({"w": torch.zeros(32)}, n, device="cpu", backend=be)
    for i in range(5):
        st, _ = step(st, None, grad_fn, cfg, mixer, is_comm_step=True)
        if i == 0:
            _state_out(out, "step1", st)
    _state_out(out, "step5", st)
    met = stationarity_metrics(st, {"global_at": lambda x: grad_fn(
        {"w": x["w"]}, None)[0], "local_at": lambda x: grad_fn(
        {"w": x["w"]}, None)[0]}, cfg, backend=be)
    for k, v in met.items():
        out[f"r:metrics/{k}"] = v.numpy()

    # the counted collective bytes of one comm step against the model
    for name, (n, sched, d) in counted_schedules(torch, world).items():
        be = counting(backend(n))
        ax = be.axis
        mixer = be.mixer_for(sched)
        st = init({"w": torch.zeros(d)}, n, device="cpu", backend=be,
                  compress=sched)
        grad = _lsq_grad(torch, n, be.rows, d)
        ax.reset()
        step(st, None, grad, DepositumConfig(**{**CFG, "comm_period": 1}),
             mixer, is_comm_step=True)
        out[f"r:bytes/{name}"] = np.asarray(
            [collective_bytes(ax), device_wire_bytes(sched, d, n, world)],
            np.float64)
    return out


def schedules(torch, world):
    """name -> (n, MixSchedule) of the reference's schedule test: dense
    bases on 2 x world clients, circulant ones on one client a rank."""
    from repro_torch.core import MixPlan, MixSchedule
    from repro_torch.core.topology import mixing_matrix
    cpu = dict(device="cpu")
    n = 2 * world
    W = mixing_matrix("ring", n)
    pc = MixPlan.circulant(*ring(world), **cpu)
    return {
        "constant": (n, MixSchedule.constant(MixPlan.dense(W, **cpu))),
        "stacked": (n, MixSchedule.stacked(
            [MixPlan.dense(mixing_matrix(t, n), **cpu)
             for t in ("ring", "star", "complete", "torus", "ring")])),
        "alternating": (n, MixSchedule.alternating(
            [MixPlan.dense(W, **cpu),
             MixPlan.dense(mixing_matrix("star", n), **cpu)])),
        "lazy-dense": (n, MixSchedule.lazy(MixPlan.dense(W, **cpu), 0.6,
                                           rounds=ROUNDS, seed=3)),
        "lazy-circulant": (world, MixSchedule.lazy(pc, 0.5, rounds=ROUNDS,
                                                   n=world, seed=7)),
        "chebyshev": (world, MixSchedule.chebyshev(pc, 3, n=world)),
        "chebyshev-dense": (n, MixSchedule.chebyshev(
            MixPlan.dense(W, **cpu), 2)),
    }


def cohort_schedule(torch, name, n_max, masks):
    """The reference's cohort schedules, the port's sampler carrying the
    reference's drawn masks (``masks[r]``)."""
    from repro_torch.core import CohortSampler, MixPlan, MixSchedule, pad_plan
    from repro_torch.core.topology import mixing_matrix
    cpu = dict(device="cpu")

    @dataclasses.dataclass(frozen=True)
    class Injected(CohortSampler):
        masks: object = None

        def mask_at(self, r):
            return self.masks[min(r, self.masks.shape[0] - 1)]

    W = MixPlan.dense(mixing_matrix("ring", n_max), **cpu)
    if name == "full":
        s, plan = CohortSampler.full(n_max, **cpu), W
    elif name == "bernoulli":
        s, plan = CohortSampler.bernoulli(0.6, n_max, seed=3, **cpu), W
    elif name == "fixed":
        s, plan = CohortSampler.fixed_size(3, n_max, seed=5, **cpu), W
    else:
        s = CohortSampler.bernoulli(0.7, n_max, seed=9, n_eff=5, **cpu)
        plan = pad_plan(MixPlan.from_topology("ring", 5, **cpu), n_max)
    fields = {f.name: getattr(s, f.name) for f in dataclasses.fields(s)}
    return MixSchedule.cohort(plan, Injected(**fields, masks=masks))


def compressed_schedules(torch, world, draws):
    """name -> (n, schedule) of the reference's compressed test, the
    randomised kinds drawing the reference's uniforms (``draws``: the
    global (n, d) block of every (round, variable, leaf) path)."""
    from repro_torch.core import CompressionSpec, MixPlan, as_schedule
    from repro_torch.core.topology import mixing_matrix
    cpu = dict(device="cpu")
    n = 2 * world

    def hook(tag):
        def draw(key, shape):
            u = draws[f"{tag}/" + "_".join(str(p) for p in key.path)]
            rows = shape[-2]
            return torch.from_numpy(u[key.row0:key.row0 + rows]).reshape(
                shape)
        return draw

    dense = as_schedule(MixPlan.dense(mixing_matrix("ring", n), **cpu))
    circ = as_schedule(MixPlan.circulant(*ring(world), **cpu))
    return {
        "topk-sim": (n, dense.with_compression(
            CompressionSpec.topk(0.25, **cpu))),
        "topk-wire": (n, dense.with_compression(
            CompressionSpec.topk(0.25, wire_k=16, **cpu))),
        "randk-wire": (n, dense.with_compression(dataclasses.replace(
            CompressionSpec.randk(0.25, seed=4, wire_k=32, **cpu),
            uniforms=hook("randk")))),
        "qsgd-wire": (n, dense.with_compression(dataclasses.replace(
            CompressionSpec.qsgd(4, seed=5, **cpu), uniforms=hook("qsgd")))),
        "topk-wire-circulant": (world, circ.with_compression(
            CompressionSpec.topk(0.25, wire_k=16, **cpu))),
    }


def counted_schedules(torch, world):
    """name -> (n, schedule, d): one comm step each, its collectives
    counted against ``device_wire_bytes``."""
    from repro_torch.core import CompressionSpec, MixPlan, as_schedule
    from repro_torch.core.topology import mixing_matrix
    cpu = dict(device="cpu")
    n = 2 * world
    dense = as_schedule(MixPlan.dense(mixing_matrix("ring", n), **cpu))
    return {
        "dense": (n, dense, DC),
        "circulant": (world, as_schedule(MixPlan.circulant(*ring(world),
                                                           **cpu)), DC),
        "complete": (world, as_schedule(MixPlan.complete()), DC),
        "topk-wire": (n, dense.with_compression(
            CompressionSpec.topk(0.25, wire_k=8, **cpu)), DC),
        "qsgd-wire": (n, dense.with_compression(
            CompressionSpec.qsgd(4, seed=5, **cpu)), DC),
    }


def suite_sweep(torch, world):
    """A stacked-W topology sweep with a circulant point, and a schedule
    grid, through ``sweep_run(backend=...)``."""
    from repro_torch.core import (DepositumConfig, Hyper, MixPlan,
                                  MixSchedule, as_stacked_schedule,
                                  stack_hypers, stack_mixplans,
                                  stack_schedules)
    from repro_torch.core.topology import mixing_matrix
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training.backends import get_backend
    from repro_torch.training.sweep import sweep_run
    cpu = dict(device="cpu")
    out = {}
    mesh = make_host_mesh(world, 1)
    cfg = DepositumConfig(momentum="polyak", comm_period=T0,
                          prox_name="l1", prox_kwargs={"lam": 1e-3})
    h = Hyper.create(alpha=0.05, beta=1.0, gamma=0.5, lam=1e-3)
    batches = {"z": torch.zeros((ROUNDS, T0, 1))}

    def run(n, plan, S):
        be = get_backend("shard_map", mesh=mesh, axis_name="data",
                         n_clients=n)
        g = _lsq_grad(torch, n, be.rows)
        fs, _ = sweep_run({"w": torch.zeros(D)}, g, cfg, plan,
                          stack_hypers([h] * S), batches, n_clients=n,
                          backend=be)
        return fs.x["w"].numpy()

    n = 2 * world
    plans = stack_mixplans([MixPlan.from_topology(t, n, **cpu)
                            for t in TOPOS])
    out["s:topo"] = run(n, plans, len(TOPOS))
    out["s:circulant"] = run(world, MixPlan.circulant(*ring(world), **cpu),
                             1)
    base = MixPlan.dense(mixing_matrix("ring", n), **cpu)
    native = ([MixSchedule.lazy(base, p, rounds=ROUNDS, seed=2)
               for p in (0.3, 0.6, 1.0)]
              + [MixSchedule.chebyshev(base, k) for k in (2, 3)])
    grid = stack_schedules([as_stacked_schedule(s, ROUNDS, n)
                            for s in native])
    out["s:sched_grid"] = run(n, grid, len(native))
    out["s:lazy_grid"] = run(n, stack_schedules(native[:3]), 3)
    return out


def suite_trainers(torch, world):
    """A FederatedTrainer run, an AsyncTrainer run and the fedopt
    baselines (a server mean, a gossip) through the backend."""
    from repro_torch.core import DepositumConfig, Hyper, MixPlan
    from repro_torch.core.fedopt import FedAlgConfig, make_algorithm
    from repro_torch.core.staleness import StragglerModel
    from repro_torch.core.topology import mixing_matrix
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training.async_runtime import (AsyncConfig, AsyncTrainer,
                                                    tabulate_batches)
    from repro_torch.training.backends import get_backend
    from repro_torch.training.sweep import sweep_run_fedalg
    from repro_torch.training.train_loop import FederatedTrainer, TrainerConfig
    out = {}
    mesh = make_host_mesh(world, 1)
    n = 2 * world
    be = get_backend("shard_map", mesh=mesh, axis_name="data", n_clients=n)
    model = trainer_model(torch)
    tc = TrainerConfig(n_clients=n, topology="ring", log_every=1,
                       depositum=DepositumConfig(
                           alpha=0.05, comm_period=T0, prox_name="l1",
                           prox_kwargs={"lam": 1e-4}, fused="auto"))
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in trainer_batches(n, ROUNDS)]
    tr = FederatedTrainer(model, tc, backend=be, telemetry=True,
                          device="cpu")
    st, hist = tr.run(tr.init_state(0), iter(batches), ROUNDS)
    _state_out(out, "trainer", st)
    out["r:trainer/loss"] = np.asarray([h["loss"] for h in hist])
    out["r:trainer/consensus_x"] = np.asarray(
        [h["consensus_x"] for h in hist])
    out["r:trainer/mean"] = tr.mean_params(st)["w"].numpy()

    at = AsyncTrainer(model, tc, straggler=StragglerModel.exponential(
        1.0, n, seed=3), async_cfg=AsyncConfig(tau=2), backend=be,
        device="cpu")
    st, _ = at.run(at.init_state(0), tabulate_batches(iter(batches),
                                                      ROUNDS), ROUNDS)
    _state_out(out, "async", st)
    out["r:async/applies"] = np.asarray(
        sum(e["type"] == "apply" for e in at.events))

    A, b = lsq(n)
    rows = be.rows
    Ar, br = torch.from_numpy(A[rows]), torch.from_numpy(b[rows])

    def grad_fn(x, batch):
        r = torch.einsum("nmd,nd->nm", Ar, x["w"]) - br
        return {"w": torch.einsum("nmd,nm->nd", Ar, r) / M}, {}

    hyp = Hyper.create(alpha=0.05, beta=1.0, gamma=0.5, lam=1e-3)
    for name, W in (("fedmid", None), ("dsgd", mixing_matrix("ring", n))):
        alg = make_algorithm(name, FedAlgConfig(
            local_steps=T0, alpha=0.05, prox_name="l1",
            prox_kwargs={"lam": 1e-3}, W=W))
        final, _ = sweep_run_fedalg(
            alg, {"w": torch.zeros(D)}, grad_fn, hyp,
            {"z": torch.zeros((ROUNDS, T0, 1))}, n_clients=n,
            plan=None if W is None else MixPlan.dense(W, device="cpu"),
            backend=be)
        out[f"s:fed/{name}"] = final.x["w"].numpy()
    return out


def trainer_model(torch):
    """The least-squares dict model of the trainer tests."""
    from repro_torch.models.registry import Model

    def loss(params, batch):
        e = batch["x"] @ params["w"] - batch["y"]
        return torch.mean(e * e), {}

    return Model(cfg=None, init=lambda seed: ({"w": torch.zeros(D)}, None),
                 forward_train=None, loss=loss, forward_decode=None,
                 init_decode_cache=None)


def trainer_batches(n, rounds, seed=0, B=4):
    rng = np.random.default_rng(seed)
    return [{"x": rng.normal(size=(T0, n, B, D)).astype(np.float32),
             "y": rng.normal(size=(T0, n, B)).astype(np.float32)}
            for _ in range(rounds)]


SUITES = {"mix": suite_mix, "sweep": suite_sweep, "trainers": suite_trainers}


def main(argv):
    suite, rank, world, store, out = argv
    rank, world = int(rank), int(world)
    torch = _torch_setup()
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        res = SUITES[suite](torch, world)
        np.savez(os.path.join(out, f"{suite}_{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
