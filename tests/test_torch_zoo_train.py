"""Port parity: the federated trainer over the zoo's attention-free and
encoder-decoder families (``_torch_zoo_train.check_trainer_parity``: two
``FederatedTrainer`` rounds against the reference's from one carried
state, fp32, x / y / nu / g / dx / ``mean_params`` within relative L2
1e-4, ``ce`` / ``moe_aux`` within rtol 1e-5): reduced ``mamba2-130m``,
``zamba2-2.7b`` (its ``shared`` block, used at every group, gets the sum
of its invocations' gradients) and ``seamless-m4t-medium`` (16 frames a
sample in the batch).  The two other files of this harness cover the
transformer families (``_dense``, ``_moe``).

Remat per block: with ``cfg.remat`` the SSM checkpoints each layer, the
hybrid each group (its Mamba2 layers and the shared block), the enc-dec
each encoder and decoder block, as the reference's scan bodies do;
``torch.utils.checkpoint`` is called exactly that often in a training
forward, and the per-client gradients and aux are bit for bit those
without remat (the recomputed forward is the same computation), under
both policies.
"""
import dataclasses

import numpy as np
import pytest
import torch

import _torch_zoo_train as Z
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.launch.steps import make_grad_fn
from repro_torch.models import build_model
from repro_torch.models import common
from repro_torch.models.hybrid import group_shape


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Small CPU ops run faster on few threads beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b",
                                  "seamless-m4t-medium"])
def test_trainer_matches_reference(arch):
    Z.check_trainer_parity(arch)


def _blocks(cfg) -> int:
    """Checkpointed calls of one training forward under remat."""
    if cfg.family == "ssm":
        return cfg.n_layers
    if cfg.family == "hybrid":
        return group_shape(cfg)[0]
    return cfg.n_encoder_layers + cfg.n_layers


def _module(arch, cfg):
    _, jp = Z.reference_params(arch)
    cls = type(build_model(cfg, device="meta").init()[0])
    return cls(cfg, model_params_from_numpy(jp, cfg, device="cpu"))


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b",
                                  "seamless-m4t-medium"])
def test_remat_per_block_is_bit_equal(arch, policy, monkeypatch):
    base = get_config(arch, reduced=True)
    batch = {k: torch.from_numpy(v[0]) for k, v in Z.batches(base)[0].items()}
    calls = []
    real = common.checkpoint

    def counted(fn, *args, **kwargs):
        calls.append(fn)
        return real(fn, *args, **kwargs)

    monkeypatch.setattr(common, "checkpoint", counted)
    grads = {}
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat, remat_policy=policy)
        module = _module(arch, cfg)
        x = {k: p.detach()[None].expand((Z.N,) + p.shape).clone()
             for k, p in module.named_parameters()}
        calls.clear()
        grads[remat] = make_grad_fn(build_model(cfg, device="cpu"),
                                    template=module)(x, batch)
        # one checkpointed call a block a client, none without remat
        assert len(calls) == (Z.N * _blocks(cfg) if remat else 0), \
            (arch, remat, len(calls))
    (g0, a0), (g1, a1) = grads[False], grads[True]
    assert sorted(g0) == sorted(g1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    assert torch.equal(a0["ce"], a1["ce"])
    assert np.isfinite(a1["ce"].numpy()).all()
