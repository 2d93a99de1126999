"""Port parity: the federated token stream and the trainer's batch
iterators, bit for bit (both sides draw with numpy).

``SyntheticTokenStream.batch`` / ``stacked_round`` and
``make_federated_lm_streams`` against ``repro.data``; the port's
``lm_batch_iterator`` / ``classification_batch_iterator`` (torch tensors
on the CPU) against the reference's (JAX arrays): equal values and dtypes
for several rounds.
"""
import numpy as np
import pytest
import torch

from repro.core import DepositumConfig as JConfig
from repro.data import SyntheticTokenStream as JStream
from repro.data import make_classification as j_make_classification
from repro.data import make_federated_lm_streams as j_streams
from repro.training.train_loop import TrainerConfig as JTrainerConfig
from repro.training.train_loop import (
    classification_batch_iterator as j_cls_iter,
    lm_batch_iterator as j_lm_iter,
)
from repro_torch.core import DepositumConfig
from repro_torch.data import (SyntheticTokenStream, make_classification,
                              make_federated_lm_streams)
from repro_torch.training import (TrainerConfig,
                                  classification_batch_iterator,
                                  lm_batch_iterator)


@pytest.mark.parametrize("vocab,clients,seed,zipf", [
    (512, 4, 0, 1.2), (1000, 3, 7, 1.05), (151936, 2, 1, 1.2)])
def test_stream_batches_bit_equal(vocab, clients, seed, zipf):
    j = JStream(vocab, clients, seed=seed, zipf_a=zipf)
    t = SyntheticTokenStream(vocab, clients, seed=seed, zipf_a=zipf)
    for c in range(clients):
        for step in (0, 3):
            a, b = t.batch(c, step, 2, 9), j.batch(c, step, 2, 9)
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    blk = t.stacked_round(5, 3, 2, 7)
    assert blk.shape == (3, clients, 2, 8)
    np.testing.assert_array_equal(blk, j.stacked_round(5, 3, 2, 7))
    np.testing.assert_array_equal(
        make_federated_lm_streams(vocab, clients, seed=seed).stacked_round(
            0, 2, 1, 4),
        j_streams(vocab, clients, seed=seed).stacked_round(0, 2, 1, 4))


def _cfgs(t0, n):
    return (TrainerConfig(n_clients=n, depositum=DepositumConfig(
        comm_period=t0)), JTrainerConfig(n_clients=n, depositum=JConfig(
            comm_period=t0)))


def test_lm_batch_iterator_bit_equal():
    tc, jc = _cfgs(3, 4)
    t = lm_batch_iterator(make_federated_lm_streams(512, 4, seed=2), tc,
                          batch=2, seq_len=16, device="cpu")
    j = j_lm_iter(j_streams(512, 4, seed=2), jc, batch=2, seq_len=16)
    for _ in range(3):
        a, b = next(t), next(j)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].shape == (3, 4, 2, 16) and a[k].device.type == "cpu"
            assert a[k].numpy().dtype == np.asarray(b[k]).dtype
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
        np.testing.assert_array_equal(a["tokens"][..., 1:].numpy(),
                                      a["labels"][..., :-1].numpy())


def test_classification_batch_iterator_bit_equal():
    tc, jc = _cfgs(2, 5)
    kw = dict(n_samples=400, n_features=12, n_classes=3, n_clients=5,
              seed=4)
    t = classification_batch_iterator(make_classification(**kw), tc,
                                      batch=6, seed=9, device="cpu")
    j = j_cls_iter(j_make_classification(**kw), jc, batch=6, seed=9)
    for _ in range(3):
        a, b = next(t), next(j)
        for k, shape in (("x", (2, 5, 6, 12)), ("y", (2, 5, 6))):
            assert tuple(a[k].shape) == shape
            assert a[k].numpy().dtype == np.asarray(b[k]).dtype
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))


def test_iterators_default_to_the_card():
    tc, _ = _cfgs(2, 2)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(lm_batch_iterator(make_federated_lm_streams(64, 2), tc, 1, 4))
