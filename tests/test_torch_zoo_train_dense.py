"""Port parity: the federated trainer over the zoo's dense decoders
besides ``qwen3-1.7b`` (``test_torch_trainer.py``): reduced
``starcoder2-7b``, ``qwen2.5-14b`` and ``minitron-4b`` through
``_torch_zoo_train.check_trainer_parity`` (two rounds against the
reference's trainer from one carried state, fp32, relative L2 1e-4 on
x / y / nu / g / dx / ``mean_params``, rtol 1e-5 on ``ce``)."""
import pytest
import torch

import _torch_zoo_train as Z


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["starcoder2-7b", "qwen2.5-14b",
                                  "minitron-4b"])
def test_trainer_matches_reference(arch):
    Z.check_trainer_parity(arch)
