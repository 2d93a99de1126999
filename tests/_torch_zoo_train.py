"""Shared harness of the zoo trainer parity files
(``test_torch_zoo_train*.py``, three archs a file so that xdist spreads
the reference's compiles over workers).

:func:`check_trainer_parity` mirrors the reference's
``test_reduced_train_step`` (``tests/test_models_smoke.py``) as a parity
test: two rounds of the port's ``FederatedTrainer`` against the
reference's from one carried state (the reference's init params through
``convert.model_params_from_numpy``), 2 clients on a complete graph, fp32,
T0 2, B 2 x L 32 a client a step.  The batches are numpy draws from a seed
that differ by step and by client: tokens and labels, a VLM's
``vision_embeds`` and an enc-dec's 16 ``frames`` a sample, so every client
slices its own.  x, y, nu, g, x's move from the start (``dx``) and
``mean_params`` within ``STATE_REL`` relative L2 (the trainer's tolerance
since ``test_torch_trainer.py``); each round's per-client ``ce`` and
``moe_aux`` within ``AUX_RTOL``.
"""
from __future__ import annotations

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget
from repro.core import DepositumConfig as JConfig
from repro.core import init as j_init
from repro.models import build_model as jbuild
from repro.training.train_loop import FederatedTrainer as JTrainer
from repro.training.train_loop import TrainerConfig as JTrainerConfig
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_numpy, model_params_to_numpy
from repro_torch.core import DepositumConfig
from repro_torch.models import build_model
from repro_torch.training import FederatedTrainer, TrainerConfig

N, T0, B, L, ROUNDS, FRAMES = 2, 2, 2, 32, 2, 16
DEP = dict(alpha=0.02, beta=1.0, gamma=0.8, comm_period=T0,
           prox_name="l1", prox_kwargs={"lam": 1e-5})
STATE_REL = 1e-4
AUX_RTOL = 1e-5


@functools.lru_cache(maxsize=None)
def reference_params(arch: str):
    """(reference model, its init params as numpy) of the reduced fp32
    config."""
    jm = jbuild(jget(arch, reduced=True))
    jp, _ = jm.init(jax.random.PRNGKey(0))
    return jm, jax.tree_util.tree_map(np.asarray, jp)


def batches(cfg, seed: int = 0) -> list[dict]:
    """ROUNDS numpy batches with leaves (T0, N, B, ...)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(ROUNDS):
        b = {k: rng.integers(0, cfg.vocab_size, (T0, N, B, L)).astype(
                 np.int32) for k in ("tokens", "labels")}
        if cfg.family == "vlm":
            b["vision_embeds"] = rng.normal(size=(
                T0, N, B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
        if cfg.family == "encdec":
            b["frames"] = rng.normal(size=(T0, N, B, FRAMES, cfg.d_model)
                                     ).astype(np.float32)
        out.append(b)
    return out


def paths(tree) -> dict:
    """{path: float32 numpy} of a reference-layout tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in flat}


def rel_l2(a: dict, b: dict) -> float:
    assert sorted(a) == sorted(b)
    num = sum(float(np.sum((a[k] - b[k]) ** 2)) for k in a)
    den = sum(float(np.sum(b[k] ** 2)) for k in a)
    return (num / max(den, 1e-30)) ** 0.5


def ref_layout(template: torch.nn.Module, flat: dict) -> dict:
    """A port ``(C, ...)`` state tree -> {path: (C, ...)} in the
    reference's layout, client by client through the module's own
    stacking (``model_params_to_numpy``)."""
    per = []
    for c in range(next(iter(flat.values())).shape[0]):
        module = copy.deepcopy(template)
        module.load_state_dict({k: v[c] for k, v in flat.items()},
                               strict=True, assign=True)
        per.append(model_params_to_numpy(module))
    return paths(jax.tree_util.tree_map(lambda *a: np.stack(a), *per))


def check_trainer_parity(arch: str) -> dict:
    """Run both trainers and assert the module docstring's bounds; returns
    the readings."""
    jm, jp = reference_params(arch)
    cfg = get_config(arch, reduced=True)
    data = batches(cfg)

    jtr = JTrainer(jm, JTrainerConfig(n_clients=N, topology="complete",
                                      depositum=JConfig(**DEP)))
    jstate = j_init(jax.tree_util.tree_map(jnp.asarray, jp), N)
    jaux = []
    for b in data:
        jstate, aux = jtr._round(jstate, jax.tree_util.tree_map(jnp.asarray,
                                                                b))
        jaux.append(aux)

    model = build_model(cfg, device="cpu")
    tr = FederatedTrainer(model, TrainerConfig(
        n_clients=N, topology="complete",
        depositum=DepositumConfig(**DEP, fused="auto")), device="cpu")
    module_cls = type(build_model(cfg, device="meta").init()[0])
    state = tr.state_from_params(module_cls(cfg, model_params_from_numpy(
        jp, cfg, device="cpu")))
    x0 = ref_layout(tr._template, state.x)
    taux = []
    for b in data:
        state, aux = tr._round(state, {k: torch.from_numpy(v)
                                       for k, v in b.items()})
        taux.append(aux)
    assert state.t == jstate.t == ROUNDS * T0

    readings = {}
    for f in ("x", "y", "nu", "g"):
        readings[f] = rel_l2(ref_layout(tr._template, getattr(state, f)),
                             paths(getattr(jstate, f)))
    got, want = ref_layout(tr._template, state.x), paths(jstate.x)
    readings["dx"] = rel_l2({k: got[k] - x0[k] for k in got},
                            {k: want[k] - x0[k] for k in want})
    mean = tr.mean_params(state)
    assert isinstance(mean, module_cls)
    readings["mean_params"] = rel_l2(paths(model_params_to_numpy(mean)),
                                     paths(jtr.mean_params(jstate)))
    for f, rel in readings.items():
        assert rel <= STATE_REL, (arch, f, rel)
    for r, (a, ja) in enumerate(zip(taux, jaux)):
        for k in ("ce", "moe_aux"):
            np.testing.assert_allclose(
                np.asarray(a[k], np.float32).reshape(N),
                np.asarray(ja[k], np.float32).reshape(N), rtol=AUX_RTOL,
                atol=0, err_msg=f"{arch} round {r} {k}")
    assert float(np.mean(np.asarray(taux[-1]["ce"]))) > 0.0
    if cfg.n_experts:
        assert float(np.min(np.asarray(taux[-1]["moe_aux"]))) > 0.0
    return readings
