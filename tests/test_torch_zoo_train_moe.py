"""Port parity: the federated trainer over the zoo's MoE and VLM
families: reduced ``grok-1-314b`` and ``qwen3-moe-235b-a22b`` (the loss
carries ``router_aux_weight`` times the router loss, static capacity with
drops) and ``phi-3-vision-4.2b`` (``vision_embeds`` in the batch, sliced
per client like the tokens) through
``_torch_zoo_train.check_trainer_parity`` (two rounds against the
reference's trainer from one carried state, fp32, relative L2 1e-4 on
x / y / nu / g / dx / ``mean_params``, rtol 1e-5 on ``ce`` and
``moe_aux``)."""
import pytest
import torch

import _torch_zoo_train as Z


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["grok-1-314b", "qwen3-moe-235b-a22b",
                                  "phi-3-vision-4.2b"])
def test_trainer_matches_reference(arch):
    Z.check_trainer_parity(arch)
