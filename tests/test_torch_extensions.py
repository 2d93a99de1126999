"""Port parity: the beyond-paper extensions (``core/extensions.py``).

* The trimmed-mean mixer on a ring (degree 2, trim 1), a complete graph
  and a torus, with and without a Byzantine row (1e6), over a dict of
  leaves (a 2-D leaf, a 1-D leaf): against
  ``repro.core.extensions.make_trimmed_mean_mixer`` within rtol 1e-6 /
  atol 1e-6 (the same sort; the kept values are summed in another
  order), and the Byzantine row trimmed away in both.  Its degree check
  raises as the reference's.
* The deprecated CHOCO shims: ``topk_compress`` bit for bit (the same
  threshold rule), and 30 ``compressed_gossip_round`` rounds on a ring
  against the reference's: x and x̂ within rtol 1e-5 / atol 1e-6, the
  traffic fraction exactly; round one (zero memory) bit for bit with the
  port's ``choco_mix``, as the reference pins its own pair.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mixing_matrix
from repro.core import extensions as jext
from repro_torch.core import (CompressionSpec, MixPlan, apply_mix, choco_mix,
                              comm_memory)
from repro_torch.core.extensions import (compressed_gossip_round,
                                         init_compressed,
                                         make_trimmed_mean_mixer,
                                         topk_compress)

TOL = dict(rtol=1e-6, atol=1e-6)


def _tree(n, seed, byzantine=None):
    rng = np.random.default_rng(seed)
    tree = {"w": rng.standard_normal((n, 5, 3)).astype(np.float32),
            "b": rng.standard_normal((n, 7)).astype(np.float32)}
    if byzantine is not None:
        for v in tree.values():
            v[byzantine] = 1e6
    return tree


@pytest.mark.parametrize("byzantine", [None, 3])
@pytest.mark.parametrize("topology,n,trim", [("ring", 8, 1),
                                             ("complete", 10, 2),
                                             ("torus", 9, 1)])
def test_trimmed_mean_matches_reference(topology, n, trim, byzantine):
    W = mixing_matrix(topology, n)
    tree = _tree(n, n, byzantine)
    want = jext.make_trimmed_mean_mixer(W, trim=trim)(
        {k: jnp.asarray(v) for k, v in tree.items()})
    got = make_trimmed_mean_mixer(W, trim=trim)(
        {k: torch.from_numpy(v) for k, v in tree.items()})
    for k in tree:
        assert got[k].dtype == torch.float32 and got[k].shape == tree[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL, err_msg=k)
    if byzantine is not None and topology == "complete":
        honest = np.delete(tree["b"], byzantine, axis=0)
        assert np.abs(got["b"].numpy()[0] - honest.mean(0)).max() < 1.0
    # a bare tensor mixes like a one-leaf tree
    bare = make_trimmed_mean_mixer(W, trim=trim)(torch.from_numpy(tree["b"]))
    assert torch.equal(bare, got["b"])


def test_trimmed_mean_degree_check_raises():
    W = mixing_matrix("ring", 8)
    for mk in (jext.make_trimmed_mean_mixer, make_trimmed_mean_mixer):
        with pytest.raises(ValueError, match="too large"):
            mk(W, trim=2)


def test_topk_compress_matches_reference():
    x = np.random.default_rng(0).standard_normal((6, 4, 8)).astype(np.float32)
    x[0, 0, :3] = 2.5  # ties at the k-th magnitude all survive
    for k in (1, 3, 7, 32, 40):
        want = np.asarray(jext.topk_compress(jnp.asarray(x), k))
        got = topk_compress(torch.from_numpy(x), k).numpy()
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        topk_compress(torch.tensor([[1.0, -5.0, 0.1, 3.0]]), 2).numpy(),
        [[0.0, -5.0, 0.0, 3.0]])


def test_compressed_gossip_rounds_match_reference():
    n, d, k = 8, 64, 8
    W = mixing_matrix("ring", n)
    x0 = np.random.default_rng(2).standard_normal((n, d)).astype(np.float32)
    jx, jst = jnp.asarray(x0), jext.init_compressed(jnp.asarray(x0))
    tx, tst = torch.from_numpy(x0), init_compressed(torch.from_numpy(x0))
    spec = CompressionSpec.topk(k / d, ef_step=0.3, device="cpu")
    plan = MixPlan.dense(W, device="cpu")
    nx, mem = {"x": torch.from_numpy(x0)}, comm_memory(
        {"x": torch.from_numpy(x0)})
    for i in range(30):
        jx, jst, jfrac = jext.compressed_gossip_round(jx, jst, W, k, step=0.3)
        tx, tst, frac = compressed_gossip_round(tx, tst, W, k, step=0.3)
        assert frac == jfrac == k / d
        if i == 0:
            nx, mem = choco_mix(spec, lambda t: apply_mix(plan, t), nx, mem)
            assert torch.equal(tx, nx["x"])
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tst.xhat.numpy(), np.asarray(jst.xhat),
                               rtol=1e-5, atol=1e-6)
    # the mean is kept (doubly stochastic mixing of the public copies)
    np.testing.assert_allclose(tx.mean(0).numpy(), x0.mean(0), atol=1e-4)
