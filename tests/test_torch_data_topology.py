"""Port parity: data, partitions, batches and mixing matrices.

The port keeps its own numpy copies of these modules, so every array must
be *exactly* equal to the reference's for the same arguments.
"""
import numpy as np
import pytest

from repro.core import topology as jtop
from repro.data import dirichlet as jdir
from repro.data import synthetic as jsyn
from repro_torch.core import topology as ttop
from repro_torch.data import dirichlet as tdir
from repro_torch.data import synthetic as tsyn


@pytest.mark.parametrize("theta", [0.1, 1.0, np.inf])
@pytest.mark.parametrize("seed", [0, 3])
def test_make_classification_and_batches_equal(theta, seed):
    kw = dict(n_samples=300, n_features=12, n_classes=5, n_clients=4,
              theta=theta, seed=seed)
    a, b = jsyn.make_classification(**kw), tsyn.make_classification(**kw)
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.y, b.y)
    assert a.x.dtype == b.x.dtype and a.y.dtype == b.y.dtype
    assert len(a.partition) == len(b.partition)
    for pa, pb in zip(a.partition, b.partition):
        np.testing.assert_array_equal(pa, pb)
    for i in range(4):
        for u, v in zip(a.client_arrays(i), b.client_arrays(i)):
            np.testing.assert_array_equal(u, v)
    ra, rb = np.random.default_rng(seed + 7), np.random.default_rng(seed + 7)
    for _ in range(2):
        for u, v in zip(a.stacked_batches(ra, 8, 3),
                        b.stacked_batches(rb, 8, 3)):
            np.testing.assert_array_equal(u, v)
            assert u.dtype == v.dtype


@pytest.mark.parametrize("balance", [True, False])
def test_dirichlet_partition_and_proportions_equal(balance):
    labels = np.random.default_rng(1).integers(0, 6, 500)
    pa = jdir.dirichlet_partition(labels, 7, 0.3, seed=2, balance=balance)
    pb = tdir.dirichlet_partition(labels, 7, 0.3, seed=2, balance=balance)
    for u, v in zip(pa, pb):
        np.testing.assert_array_equal(u, v)
    np.testing.assert_array_equal(jdir.label_proportions(pa, labels, 6),
                                  tdir.label_proportions(pb, labels, 6))


@pytest.mark.parametrize("topology", ["complete", "ring", "star", "torus",
                                      "erdos"])
@pytest.mark.parametrize("n", [1, 2, 3, 6, 9, 10])
def test_mixing_matrix_and_spectral_quantities_equal(topology, n):
    Wa = jtop.mixing_matrix(topology, n)
    Wb = ttop.mixing_matrix(topology, n)
    np.testing.assert_array_equal(Wa, Wb)
    assert jtop.spectral_lambda(Wa) == ttop.spectral_lambda(Wb)
    if n > 1 and topology != "complete":
        for k in (1, 2, 3):
            np.testing.assert_array_equal(jtop.chebyshev_matrix(Wa, k),
                                          ttop.chebyshev_matrix(Wb, k))
        active = np.arange(n) % 2 == 0
        np.testing.assert_array_equal(jtop.lazy_subgraph_matrix(Wa, active),
                                      ttop.lazy_subgraph_matrix(Wb, active))


@pytest.mark.parametrize("seed", [0, 1, 5])
@pytest.mark.parametrize("p", [0.2, 0.7])
def test_erdos_renyi_seeded_equal(seed, p):
    np.testing.assert_array_equal(
        jtop.mixing_matrix("erdos", 8, p=p, seed=seed),
        ttop.mixing_matrix("erdos", 8, p=p, seed=seed))


@pytest.mark.parametrize("W", [
    np.array([[0.5, 0.6], [0.5, 0.4]]),          # not symmetric
    np.array([[0.7, 0.2], [0.2, 0.7]]),          # rows do not sum to 1
    np.array([[1.2, -0.2], [-0.2, 1.2]]),        # negative entries
    np.eye(3),                                   # disconnected
])
def test_validate_mixing_raises_alike(W):
    with pytest.raises(ValueError) as ea:
        jtop.validate_mixing(W)
    with pytest.raises(ValueError) as eb:
        ttop.validate_mixing(W)
    assert str(ea.value) == str(eb.value)


@pytest.mark.parametrize("lam,alpha_rho,T0", [(0.0, 0.1, 3), (0.4, 0.2, 5),
                                              (0.9, 0.0, 1)])
def test_delta_coefficients_equal(lam, alpha_rho, T0):
    assert (jtop.delta_coefficients(lam, alpha_rho, T0)
            == ttop.delta_coefficients(lam, alpha_rho, T0))


def test_chebyshev_matrix_rejects_alike():
    for bad, k in ((np.ones((2, 3)), 2), (jtop.ring_graph(5), 0),
                   (np.array([[0.5, 0.5], [0.4, 0.6]]), 2)):
        with pytest.raises(ValueError):
            jtop.chebyshev_matrix(bad, k)
        with pytest.raises(ValueError):
            ttop.chebyshev_matrix(bad, k)
