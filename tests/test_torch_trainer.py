"""Port parity: the federated trainer, its gradients and its backends.

* Per-client value and gradients of reduced fp32 ``qwen3-1.7b``
  (``launch/steps.py``: clients one after another through
  ``torch.autograd.grad`` on views of the stacked state) against
  ``repro.launch.steps.make_value_grad_fn`` (``vmap(value_and_grad)``)
  from the same converted weights: loss rtol 1e-5, gradients atol 1e-5 /
  rtol 1e-4 (the same fp32 operations, matmul sums in another order).
* Remat on (``torch.utils.checkpoint`` a block, "full" and "dots")
  against remat off: bit for bit on the CPU (the recomputed forward is
  the same computation).  ``microbatch=2`` against 1: atol 1e-6 / rtol
  1e-5 (two half-batch means averaged).
* Two rounds of ``FederatedTrainer`` (reduced qwen3, 4 clients on a ring,
  T0 2, B 2, L 16, tokens from the shared numpy stream) against the
  reference's ``FederatedTrainer``: x, y, nu, g and ``mean_params`` within
  relative L2 1e-4, logged losses within rtol 1e-5 (the reference is not
  bit-stable on this JAX: its tau = 0 pin fails).  In bf16 with remat and
  donated rounds, under the launcher's hyperparameters (2 clients,
  complete, T0 4, 6 rounds, as at full width): the states within
  ``BF16_REL`` (limits and readings there) and the losses round by round,
  which fall every round in both packages.
  ``donate=True`` gives the same trajectory bit for bit and empties the
  input state.
* A least-squares dict model (the reference tests' ``_ls_model``) through
  the trainer under a dense, a cohort (the reference's masks injected:
  the port draws cohorts from a counter hash) and a top-k compressed
  schedule against the reference's trainer: rtol 1e-5 / atol 1e-6.
* ``build_train_step`` / ``build_local_step`` (two steps of the
  least-squares model) and ``SweepBackend.run`` (a two-config grid of it)
  against the reference's: ``LS_TOL``.  ``time_fn`` calls its function as
  often as the reference's and returns the same fields.
* ``_logged_rounds`` exactly; ``suggest_backend_name`` exactly over a
  table of kinds x clients x devices x wire bytes; one process gets the
  stacked backend, and where the rule picks shard_map the port raises.
"""
import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import CohortSampler as JSampler
from repro.core import CompressionSpec as JSpec
from repro.core import DepositumConfig as JConfig
from repro.core import MixPlan as JPlan
from repro.core import MixSchedule as JSched
from repro.core import init as j_init
from repro.core import pad_plan as j_pad_plan
from repro.data import make_federated_lm_streams as j_streams
from repro.models import build_model as jbuild
from repro.models.registry import Model as JModel
from repro.core import stack_hypers as j_stack_hypers
from repro.obs.trace import time_fn as j_time_fn
from repro.training.backends import SweepBackend as JSweepBackend
from repro.training.backends import suggest_backend_name as j_suggest
from repro.training.train_loop import FederatedTrainer as JTrainer
from repro.training.train_loop import TrainerConfig as JTrainerConfig
from repro.training.train_loop import lm_batch_iterator as j_lm_iter
from repro.launch.steps import make_value_grad_fn as j_value_grad_fn  # noqa: E402,I001 (after repro.training: the reference's import cycle)
from repro.launch.steps import build_local_step as j_local_step  # noqa: E402,I001
from repro.launch.steps import build_train_step as j_train_step  # noqa: E402,I001
from repro_torch.configs import get_config
from repro_torch.convert import (transformer_params_from_numpy,
                                 transformer_params_to_numpy)
from repro_torch.core import (CohortSampler, CompressionSpec,
                              DepositumConfig, MixPlan, MixSchedule,
                              pad_plan, stack_hypers)
from repro_torch.core.schedule import VALIDATE_ROUNDS_CAP
from repro_torch.data import make_federated_lm_streams
from repro_torch.core import init as t_init
from repro_torch.launch.steps import (build_local_step, build_train_step,
                                      make_grad_fn, make_value_grad_fn)
from repro_torch.models import build_model
from repro_torch.models.registry import Model
from repro_torch.models.transformer import Transformer
from repro_torch.obs.trace import Timing, time_fn
from repro_torch.training import (LATENCY_BYTES_FLOOR, FederatedTrainer,
                                  StackedVmapBackend, SweepBackend,
                                  TrainerConfig, get_backend,
                                  lm_batch_iterator, suggest_backend,
                                  suggest_backend_name)

ARCH = "qwen3-1.7b"
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
STATE_REL = 1e-4
# bf16 storage (2^-8 a rounding): the gradients pass through a chain of
# bf16 ops whose sums run in another order.  Relative L2 against the
# reference after 6 rounds of T0 4 (x as its move from the start, "dx": x
# itself moves by ~1.1e-2 relative, less than its bf16 noise would show).
# Readings (CPU, 2 threads):   dx     y      nu     g      losses (rtol)
#   sound run                  0.040  0.027  0.026  0.020  9.0e-5
#   gradients x 0.95           0.082  0.087  0.078  0.085  1.2e-2
#   half of each batch         0.60   1.04   1.02   1.04   6.4e-2
#   x left at its start        1.0
# Each limit lies between the sound run and the nearest control.
BF16_REL = {"dx": 6e-2, "y": 5e-2, "nu": 5e-2, "g": 5e-2}
BF16_LOSS_RTOL = 1e-3
LOSS_RTOL = 1e-5
LS_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Small CPU ops run faster on few threads beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _reduced():
    """(reference model, its params as numpy, port config)."""
    jm = jbuild(jget(ARCH, reduced=True))
    jp, _ = jm.init(jax.random.PRNGKey(0))
    return jm, jax.tree_util.tree_map(np.asarray, jp), get_config(
        ARCH, reduced=True)


def _module(cfg=None):
    jm, jp, tcfg = _reduced()
    cfg = cfg or tcfg
    return Transformer(cfg, transformer_params_from_numpy(jp, cfg,
                                                          device="cpu"))


def _stack(module, n):
    return {k: p.detach()[None].expand((n,) + p.shape).clone()
            for k, p in module.named_parameters()}


def _nested(flat, c):
    """Client c of a port ``(C, ...)`` tree in the port's params layout."""
    out = {"blocks": [{} for _ in range(_reduced()[2].n_layers)]}
    for name, v in flat.items():
        parts = name.split(".")
        node = out
        if parts[0] == "blocks":
            node, parts = out["blocks"][int(parts[1])], parts[2:]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v[c]
    return out


def _ref_layout(flat):
    """A port ``(C, ...)`` tree -> {path: (C, ...) numpy} in the reference's
    layout (layers stacked after the client axis)."""
    C = next(iter(flat.values())).shape[0]
    per = [transformer_params_to_numpy(_nested(flat, c), _reduced()[2])
           for c in range(C)]
    return _paths(jax.tree_util.tree_map(lambda *a: np.stack(a), *per))


def _paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(p.key) for p in path): np.asarray(v, np.float32)
            for path, v in flat}


def _rel_l2(a: dict, b: dict) -> float:
    assert sorted(a) == sorted(b)
    num = sum(float(np.sum((a[k] - b[k]) ** 2)) for k in a)
    den = sum(float(np.sum(b[k] ** 2)) for k in a)
    return (num / max(den, 1e-30)) ** 0.5


def _token_batch(C=2, B=2, L=16, seed=3):
    blk = make_federated_lm_streams(512, C, seed=seed).stacked_round(
        0, 1, B, L)[0]
    return {"tokens": blk[..., :-1], "labels": blk[..., 1:]}


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------

def test_value_and_grads_match_reference():
    jm, jp, cfg = _reduced()
    batch = _token_batch()
    module = _module()
    x = _stack(module, 2)
    g, aux = make_value_grad_fn(build_model(cfg, device="cpu"),
                                template=module)(
        x, {k: torch.from_numpy(v) for k, v in batch.items()})
    xs = jax.tree_util.tree_map(lambda v: jnp.broadcast_to(v, (2,) + v.shape),
                                jp)
    jg, jaux = jax.jit(j_value_grad_fn(jm))(
        xs, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(aux["loss"].numpy(), np.asarray(jaux["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(aux["ce"].numpy(), np.asarray(jaux["ce"]),
                               rtol=LOSS_RTOL)
    assert aux["loss"].shape == (2,) and float(aux["loss"][0]) != float(
        aux["loss"][1])                          # two clients, two batches
    got, want = _ref_layout(g), _paths(jg)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_is_bit_equal_to_no_remat(policy):
    cfg = _reduced()[2]
    batch = {k: torch.from_numpy(v) for k, v in _token_batch().items()}
    grads = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat, remat_policy=policy)
        module = _module(c)
        grads[remat] = make_grad_fn(build_model(c, device="cpu"),
                                    template=module)(_stack(module, 2), batch)
    (g0, a0), (g1, a1) = grads[False], grads[True]
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    assert torch.equal(a0["ce"], a1["ce"])


def test_remat_checkpoints_every_block():
    cfg = dataclasses.replace(_reduced()[2], remat=True)
    module = _module(cfg)
    calls = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: calls.append(t.shape) or t, lambda t: t):
        module.forward_train({"tokens": torch.zeros((1, 4), dtype=torch.long)})
    # with remat a block saves only what checkpoint keeps (no activations
    # of its attention and MLP): far fewer saved tensors than without
    remat_saved = len(calls)
    calls.clear()
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: calls.append(t.shape) or t, lambda t: t):
        _module(dataclasses.replace(cfg, remat=False)).forward_train(
            {"tokens": torch.zeros((1, 4), dtype=torch.long)})
    assert remat_saved < len(calls) / 2


def test_microbatch_matches_full_batch():
    cfg = _reduced()[2]
    batch = {k: torch.from_numpy(v) for k, v in _token_batch(B=4).items()}
    module = _module()
    x = _stack(module, 2)
    model = build_model(cfg, device="cpu")
    g1, _ = make_grad_fn(model, template=module)(x, batch)
    g2, aux = make_grad_fn(model, microbatch=2, template=module)(x, batch)
    for k in g1:
        torch.testing.assert_close(g2[k], g1[k], atol=1e-6, rtol=1e-5)
    assert aux["ce"].shape == (2,)


# ---------------------------------------------------------------------------
# The trainer against the reference's
# ---------------------------------------------------------------------------

N, T0, B, L, ROUNDS = 4, 2, 2, 16, 2
DEP = dict(alpha=0.02, beta=1.0, gamma=0.8, comm_period=T0,
           prox_name="l1", prox_kwargs={"lam": 1e-5})


@pytest.fixture(scope="module")
def reference_run():
    """The reference trainer's two rounds, built once for the module."""
    jm, jp, _ = _reduced()
    tc = JTrainerConfig(n_clients=N, topology="ring", depositum=JConfig(**DEP),
                        log_every=1)
    tr = JTrainer(jm, tc)
    state = j_init(jax.tree_util.tree_map(jnp.asarray, jp), N)
    it = j_lm_iter(j_streams(512, N, seed=5), tc, batch=B, seq_len=L)
    state, hist = tr.run(state, it, ROUNDS)
    return state, hist, _paths(tr.mean_params(state))


def _port_run(donate=False, fused="auto"):
    cfg = _reduced()[2]
    tc = TrainerConfig(n_clients=N, topology="ring", log_every=1,
                       depositum=DepositumConfig(**DEP, fused=fused))
    tr = FederatedTrainer(build_model(cfg, device="cpu"), tc, device="cpu")
    state = tr.state_from_params(_module())
    it = lm_batch_iterator(make_federated_lm_streams(512, N, seed=5), tc,
                           batch=B, seq_len=L, device="cpu")
    start = state
    state, hist = tr.run(state, it, ROUNDS, donate=donate)
    return tr, start, state, hist


def test_trainer_matches_reference(reference_run):
    jstate, jhist, jmean = reference_run
    tr, _, state, hist = _port_run()
    assert state.t == jstate.t == ROUNDS * T0
    for f in ("x", "y", "nu", "g"):
        rel = _rel_l2(_ref_layout(getattr(state, f)),
                      _paths(getattr(jstate, f)))
        assert rel <= STATE_REL, (f, rel)
    assert [h["round"] for h in hist] == [h["round"] for h in jhist] == [1, 2]
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in jhist], rtol=LOSS_RTOL)
    mean = tr.mean_params(state)
    assert isinstance(mean, Transformer)
    got = _paths(transformer_params_to_numpy(mean, mean.cfg))
    assert _rel_l2(got, jmean) <= STATE_REL
    # the template went to meta; the consensus module is real
    assert tr._template.embed["table"].device.type == "meta"
    assert mean.embed["table"].device.type == "cpu"


def test_bf16_trainer_matches_reference():
    """bf16 storage, remat and donated rounds, as at full width, under
    ``launch/train.py``'s hyperparameters (2 clients, complete, T0 4,
    alpha 0.02, gamma 0.8, beta 1, l1 1e-5), 6 rounds of B 2 x L 16: the
    states within ``BF16_REL`` and each round's loss within
    ``BF16_LOSS_RTOL`` of the reference's; the loss falls every round."""
    jm, jp, cfg = _reduced()
    jcfg = dataclasses.replace(jm.cfg, dtype="bfloat16", remat=True)
    tcfg = dataclasses.replace(cfg, dtype="bfloat16", remat=True)
    dep = dict(DEP, comm_period=4)
    rounds = 6
    jtc = JTrainerConfig(n_clients=2, topology="complete", log_every=1,
                         depositum=JConfig(**dep))
    jtr = JTrainer(jbuild(jcfg), jtc)
    jstart = j_init(jax.tree_util.tree_map(
        lambda v: jnp.asarray(v, jnp.bfloat16), jp), 2)
    jstate, jhist = jtr.run(
        jstart, j_lm_iter(j_streams(512, 2, seed=6), jtc, batch=B, seq_len=L),
        rounds)
    tc = TrainerConfig(n_clients=2, topology="complete", log_every=1,
                       depositum=DepositumConfig(**dep, fused="auto"))
    tr = FederatedTrainer(build_model(tcfg, device="cpu"), tc, device="cpu")
    state, hist = tr.run(
        tr.state_from_params(Transformer(tcfg, transformer_params_from_numpy(
            jp, tcfg, device="cpu"))),
        lm_batch_iterator(make_federated_lm_streams(512, 2, seed=6), tc,
                          batch=B, seq_len=L, device="cpu"), rounds,
        donate=True)
    assert state.x["embed.table"].dtype == torch.bfloat16
    x0 = _paths(jstart.x)
    moved = lambda t: {k: v - x0[k] for k, v in t.items()}
    got = {"dx": moved(_ref_layout(state.x)), **{
        f: _ref_layout(getattr(state, f)) for f in ("y", "nu", "g")}}
    want = {"dx": moved(_paths(jstate.x)), **{
        f: _paths(getattr(jstate, f)) for f in ("y", "nu", "g")}}
    for f, limit in BF16_REL.items():
        rel = _rel_l2(got[f], want[f])
        assert rel <= limit, (f, rel)
    losses = [h["loss"] for h in hist]
    print("bf16 losses, port", losses, "reference",
          [h["loss"] for h in jhist])
    np.testing.assert_allclose(losses, [h["loss"] for h in jhist],
                               rtol=BF16_LOSS_RTOL)
    assert all(b < a for a, b in zip(losses, losses[1:])), losses


@pytest.mark.parametrize("fused", ["auto", "off"])
def test_donated_run_is_bit_equal_and_consumes_its_input(fused):
    _, start, kept, _ = _port_run(donate=False, fused=fused)
    _, start_d, donated, _ = _port_run(donate=True, fused=fused)
    assert len(start.x) == 11 * 2 + 3 and all(len(getattr(start_d, f)) == 0
                                              for f in ("x", "y", "nu", "g"))
    # Polyak momentum carries mu unchanged: the same dict, never emptied
    assert start_d.mu is donated.mu and len(donated.mu) == len(start.x)
    for f in ("x", "y", "nu", "mu", "g"):
        a, b = getattr(kept, f), getattr(donated, f)
        assert all(torch.equal(a[k], b[k]) for k in a), f


# ---------------------------------------------------------------------------
# A dict model under schedules (the reference tests' least squares)
# ---------------------------------------------------------------------------

LS_N, LS_D, LS_B, LS_T0, LS_ROUNDS = 6, 5, 4, 3, 4


def _ls_loss_j(params, batch):
    e = batch["x"] @ params["w"] - batch["y"]
    return jnp.mean(e * e), {}


def _ls_loss_t(params, batch):
    e = batch["x"] @ params["w"] - batch["y"]
    return torch.mean(e * e), {}


def _ls_models():
    j = JModel(cfg=None, init=lambda key: ({"w": jnp.zeros((LS_D,))}, None),
               forward_train=None, loss=_ls_loss_j, forward_decode=None,
               init_decode_cache=None)
    t = Model(cfg=None, init=lambda seed: ({"w": torch.zeros(LS_D)}, None),
              forward_train=None, loss=_ls_loss_t, forward_decode=None,
              init_decode_cache=None)
    return j, t


def _ls_batches():
    rng = np.random.default_rng(0)
    return [{"x": rng.normal(size=(LS_T0, LS_N, LS_B, LS_D)).astype(np.float32),
             "y": rng.normal(size=(LS_T0, LS_N, LS_B)).astype(np.float32)}
            for _ in range(LS_ROUNDS)]


@dataclasses.dataclass(frozen=True)
class Injected(CohortSampler):
    """The port's sampler with the reference's masks (``masks[r]``)."""

    masks: torch.Tensor = None

    def mask_at(self, r):
        return self.masks[r]


def _schedules(kind):
    if kind == "dense":
        return (JSched.constant(JPlan.from_topology("ring", LS_N)),
                MixSchedule.constant(MixPlan.from_topology(
                    "ring", LS_N, device="cpu")))
    if kind == "topk":
        return (JSched.from_topology("ring", LS_N).with_compression(
                    JSpec.topk(0.4)),
                MixSchedule.from_topology("ring", LS_N, device="cpu")
                .with_compression(CompressionSpec.topk(0.4, device="cpu")))
    n = LS_N - 2                                      # cohort, padded
    js = JSched.cohort(j_pad_plan(JPlan.from_topology("ring", n), LS_N),
                       JSampler.bernoulli(0.6, LS_N, seed=4, n_eff=n))
    masks = torch.from_numpy(np.stack([np.asarray(js.sampler.mask_at(r))
                                       for r in range(VALIDATE_ROUNDS_CAP)]))
    sampler = CohortSampler.bernoulli(0.6, LS_N, seed=4, n_eff=n,
                                      device="cpu")
    fields = {f.name: getattr(sampler, f.name)
              for f in dataclasses.fields(sampler)}
    return js, MixSchedule.cohort(
        pad_plan(MixPlan.from_topology("ring", n, device="cpu"), LS_N),
        Injected(**fields, masks=masks))


@pytest.mark.parametrize("kind", ["dense", "cohort", "topk"])
def test_dict_model_trainer_under_schedules(kind):
    jmodel, tmodel = _ls_models()
    jsched, tsched = _schedules(kind)
    jtc = JTrainerConfig(n_clients=LS_N, depositum=JConfig(
        alpha=0.05, comm_period=LS_T0, prox_name="l1",
        prox_kwargs={"lam": 1e-4}), log_every=2)
    # the fused cohort step freezes idle rows inside the kernel, before the
    # gradient, where the reference computes them and selects after; the
    # states agree, but the logged loss (a mean over every row) would not
    ttc = TrainerConfig(n_clients=LS_N, log_every=2,
                        depositum=DepositumConfig(
                            alpha=0.05, comm_period=LS_T0, prox_name="l1",
                            prox_kwargs={"lam": 1e-4},
                            fused="off" if kind == "cohort" else "auto"))
    jtr = JTrainer(jmodel, jtc, schedule=jsched)
    ttr = FederatedTrainer(tmodel, ttc, schedule=tsched, device="cpu")
    batches = _ls_batches()
    jstate, jhist = jtr.run(
        j_init({"w": jnp.zeros((LS_D,))}, LS_N, compress=jsched),
        iter([{k: jnp.asarray(v) for k, v in b.items()} for b in batches]),
        LS_ROUNDS)
    tstate, thist = ttr.run(
        ttr.init_state(0),
        iter([{k: torch.from_numpy(v) for k, v in b.items()}
              for b in batches]), LS_ROUNDS)
    assert bool(tstate.comm) == (kind == "topk")
    for f in ("x", "y", "nu", "g"):
        np.testing.assert_allclose(getattr(tstate, f)["w"].numpy(),
                                   np.asarray(getattr(jstate, f)["w"]),
                                   **LS_TOL, err_msg=f)
    assert [h["round"] for h in thist] == [h["round"] for h in jhist] == [2, 4]
    np.testing.assert_allclose([h["loss"] for h in thist],
                               [h["loss"] for h in jhist], rtol=LOSS_RTOL)
    np.testing.assert_allclose(ttr.mean_params(tstate)["w"].numpy(),
                               np.asarray(jtr.mean_params(jstate)["w"]),
                               **LS_TOL)


@pytest.mark.parametrize("kind", ["train", "local"])
def test_step_builders_match_reference(kind):
    """Two steps of ``build_train_step`` (ring mixing) or
    ``build_local_step`` from the least-squares model's start."""
    jmodel, tmodel = _ls_models()
    kw = dict(alpha=0.05, comm_period=LS_T0, prox_name="l1",
              prox_kwargs={"lam": 1e-4})
    if kind == "train":
        jstep = j_train_step(jmodel, JConfig(**kw), LS_N, topology="ring")
        tstep = build_train_step(tmodel, DepositumConfig(**kw), LS_N,
                                 topology="ring", device="cpu")
    else:
        jstep = j_local_step(jmodel, JConfig(**kw))
        tstep = build_local_step(tmodel, DepositumConfig(**kw))
    jstate = j_init({"w": jnp.zeros((LS_D,))}, LS_N)
    tstate = t_init({"w": torch.zeros(LS_D)}, LS_N, device="cpu")
    for b in _ls_batches()[:2]:
        jstate, _ = jstep(jstate, {k: jnp.asarray(v[0]) for k, v in b.items()})
        tstate, _ = tstep(tstate, {k: torch.from_numpy(v[0])
                                   for k, v in b.items()})
    assert int(tstate.t) == int(jstate.t) == 2
    for f in ("x", "y", "nu", "g"):
        np.testing.assert_allclose(getattr(tstate, f)["w"].numpy(),
                                   np.asarray(getattr(jstate, f)["w"]),
                                   **LS_TOL, err_msg=f)


def test_sweep_backend_run_matches_reference():
    """``get_backend("sweep").run``: two step sizes of the least-squares
    model on a ring, as one grid, against the reference's."""
    kw = dict(comm_period=LS_T0, prox_name="l1", prox_kwargs={"lam": 1e-4})
    alphas = (0.05, 0.1)
    batches = _ls_batches()
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    jgrad = jax.vmap(jax.grad(lambda w, b: _ls_loss_j(w, b)[0]))
    jcfg = JConfig(**kw)
    jfinal, _ = JSweepBackend().run(
        {"w": jnp.zeros((LS_D,))}, lambda x, b: (jgrad(x, b), {}), jcfg,
        JPlan.from_topology("ring", LS_N),
        j_stack_hypers([jcfg.hyper()._replace(alpha=jnp.float32(a))
                        for a in alphas]),
        {k: jnp.asarray(v) for k, v in stacked.items()}, n_clients=LS_N)
    tgrad = torch.func.vmap(torch.func.grad(
        lambda w, b: _ls_loss_t(w, b)[0]))
    tcfg = DepositumConfig(**kw)
    tfinal, _ = get_backend("sweep").run(
        {"w": torch.zeros(LS_D)}, lambda x, b: (tgrad(x, b), {}), tcfg,
        MixPlan.from_topology("ring", LS_N, device="cpu"),
        stack_hypers([tcfg.hyper().replace(alpha=a) for a in alphas]),
        {k: torch.from_numpy(v) for k, v in stacked.items()},
        n_clients=LS_N)
    assert tfinal.x["w"].shape == (2, LS_N, LS_D)
    for f in ("x", "y", "nu", "g"):
        np.testing.assert_allclose(getattr(tfinal, f)["w"].numpy(),
                                   np.asarray(getattr(jfinal, f)["w"]),
                                   **LS_TOL, err_msg=f)


def test_time_fn_calls_as_the_reference_does():
    calls = {"port": 0, "ref": 0}

    def counted(key):
        def fn(v):
            calls[key] += 1
            return v
        return fn

    t = time_fn(counted("port"), torch.ones(3), iters=5, warmup=2)
    r = j_time_fn(counted("ref"), jnp.ones(3), iters=5, warmup=2)
    assert calls["port"] == calls["ref"] == 2 + 2 * 5
    assert isinstance(t, Timing) and t._fields == type(r)._fields
    assert t.blocked_us > 0 and t.dispatch_us > 0


# ---------------------------------------------------------------------------
# Cadence, backends, entry-point guards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_rounds,log_every",
                         [(1, 10), (10, 10), (12, 5), (7, 1), (9, 0), (0, 3)])
def test_logged_rounds_match_reference(n_rounds, log_every):
    tc = TrainerConfig(n_clients=2, log_every=log_every)
    ttr = FederatedTrainer(_ls_models()[1], tc, device="cpu")
    ref = JTrainer._logged_rounds(
        SimpleNamespace(cfg=SimpleNamespace(log_every=log_every)), n_rounds)
    assert ttr._logged_rounds(n_rounds) == ref


def test_suggest_backend_name_matches_reference():
    cases = 0
    for kind in ("circulant", "dense", "complete", "identity", "chebyshev"):
        for n_clients in (1, 2, 4, 6, 8):
            for n_devices in (1, 2, 4, 8):
                for wire in (None, 0.0, LATENCY_BYTES_FLOOR - 1,
                             LATENCY_BYTES_FLOOR, 1e9):
                    assert suggest_backend_name(
                        kind, n_clients, n_devices, wire_bytes=wire) == \
                        j_suggest(kind, n_clients, n_devices,
                                  wire_bytes=wire), (kind, n_clients,
                                                     n_devices, wire)
                    cases += 1
    assert cases == 500


def test_backends_of_one_process():
    ring = MixPlan.from_topology("ring", 4, device="cpu")
    assert isinstance(suggest_backend(ring, 4), StackedVmapBackend)
    with pytest.raises(NotImplementedError, match="item 5c"):
        suggest_backend(MixPlan.from_topology("complete", 4, device="cpu"),
                        4, devices=[0, 1])
    # a compressed payload under the floor stays on the simulation
    sched = MixSchedule.from_topology("ring", 4, device="cpu") \
        .with_compression(CompressionSpec.topk(0.01, device="cpu"))
    assert isinstance(suggest_backend(sched, 4, devices=[0, 1, 2, 3],
                                      param_dim=100), StackedVmapBackend)
    with pytest.raises(NotImplementedError, match="item 5c"):
        get_backend("shard_map")
    sweep = get_backend("sweep")
    assert isinstance(sweep, SweepBackend) and sweep.supports_fused_sweep
    assert isinstance(get_backend("stacked-vmap"), StackedVmapBackend)
    with pytest.raises(KeyError):
        get_backend("pmap")


def test_trainer_guards():
    tmodel = _ls_models()[1]
    with pytest.raises(NotImplementedError, match="item 8"):
        FederatedTrainer(tmodel, TrainerConfig(n_clients=2), telemetry=True,
                         device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            FederatedTrainer(tmodel, TrainerConfig(n_clients=2))
