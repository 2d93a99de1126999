"""Port parity: the roofline analysis (``repro_torch.analysis.roofline``)
and the card's hardware model (``repro_torch.launch.mesh.HW``).

The reference's ``roofline_terms`` / ``fused_sweep_roofline`` read
``repro.launch.mesh.HW``, a TPU v5e's constants; each test patches that
dict's entries to the port's H100 values (``monkeypatch.setitem``, undone
after the test) and then asks both packages the same questions: every
architecture of the zoo under every ``INPUT_SHAPES`` entry.  The formulas
are the same host arithmetic on the same float64 numbers: equal exactly.
"""
import jax
import pytest
import torch

from repro.analysis import roofline as jroof
from repro.configs import get_config as jget
from repro.configs import list_archs as jlist
from repro.launch import mesh as jmesh
from repro_torch import analysis
from repro_torch.analysis import roofline as troof
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch import mesh as tmesh


@pytest.fixture
def h100_reference(monkeypatch):
    """The reference's HW dict holding the port's H100 values."""
    for key in jmesh.HW:
        monkeypatch.setitem(jmesh.HW, key, tmesh.HW[key])


def test_hw_is_one_h100_sxm():
    assert tmesh.HW == {"peak_flops_bf16": 989e12, "hbm_bandwidth": 3.35e12,
                        "ici_bandwidth": 25e9, "peak_flops_fp32": 67e12}
    assert set(jmesh.HW) <= set(tmesh.HW)
    assert troof.HW is tmesh.HW
    for name in ("roofline_terms", "fused_sweep_traffic",
                 "fused_sweep_roofline", "model_flops"):
        assert getattr(analysis, name) is getattr(troof, name)


def test_mesh_builders_wait_for_the_distributed_backends():
    """The mesh builders have landed: without a process group the
    production meshes are abstract (the reference's axis shapes, no
    processes behind them), and the host mesh covers this one process,
    refusing more as the reference refuses more devices than it has."""
    assert tmesh.make_production_mesh().shape == {"data": 16, "model": 16}
    assert tmesh.make_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}
    with pytest.raises(ValueError, match="no processes behind it"):
        tmesh.make_production_mesh().axis("data")
    host = tmesh.make_host_mesh(1, 1)
    assert host.shape == {"data": 1, "model": 1}
    ax = host.axis("data")
    x = torch.arange(6.0).reshape(3, 2)
    assert ax.axis_index() == 0 and ax.rows(3) == slice(0, 3)
    for out in (ax.ppermute(x, [(0, 0)]), ax.all_gather(x), ax.pmean(x),
                ax.psum(x)):
        assert torch.equal(out, x)
    n = len(jax.devices())
    with pytest.raises(ValueError) as ref:
        jmesh.make_host_mesh(n + 1, 1)
    with pytest.raises(ValueError) as port:
        tmesh.make_host_mesh(2, 1)
    assert str(port.value) == str(ref.value).replace(str(n + 1), "2")


@pytest.mark.parametrize("arch", sorted(jlist()))
def test_model_flops_and_roofline_terms_match_reference(arch, h100_reference):
    """Every INPUT_SHAPES entry of ``arch``, full and reduced: the model's
    flops, then the roofline of (those flops, the bf16 weights' bytes, a
    gossip of the weights) per device and over 256 and 4 chips."""
    assert set(INPUT_SHAPES) == set(jroof.INPUT_SHAPES)
    for reduced in (False, True):
        t, j = get_config(arch, reduced), jget(arch, reduced)
        for shape in INPUT_SHAPES:
            flops = troof.model_flops(t, shape)
            assert flops == jroof.model_flops(j, shape) > 0
            nbytes = 2.0 * t.param_count()
            for kw in ({}, {"per_device": False},
                       {"per_device": False, "chips": 4}):
                for coll in (0.0, nbytes, 1e3 * nbytes):
                    got = troof.roofline_terms(flops, nbytes, coll, **kw)
                    assert got == jroof.roofline_terms(flops, nbytes, coll,
                                                       **kw)
                    assert got["dominant"] in ("compute", "memory",
                                               "collective")


@pytest.mark.parametrize("d,S,C,dtype_bytes,padded", [
    (123 * 64 + 64 + 64 * 32 + 32 + 32 * 10 + 10, 1, 10, 4, None),
    (1001, 4, 10, 4, 1024),
    (2_032_264_192, 1, 2, 2, None),
])
def test_fused_sweep_traffic_and_roofline_match_reference(
        d, S, C, dtype_bytes, padded, h100_reference):
    got = troof.fused_sweep_traffic(d, S, C, dtype_bytes=dtype_bytes,
                                    padded=padded)
    want = jroof.fused_sweep_traffic(d, S, C, dtype_bytes=dtype_bytes,
                                     padded=padded)
    assert got == want and got["hbm_sweep_ratio"] == 1.6
    for seconds in (0.0, 1e-4, 12.13e-3):
        assert troof.fused_sweep_roofline(got, seconds) == \
            jroof.fused_sweep_roofline(want, seconds)


def test_roofline_dominant_term_on_the_h100():
    """The reference's ``test_roofline_dominant_term`` at the card's
    rates: one second of each term."""
    assert troof.roofline_terms(989e12, 0.0, 0.0)["dominant"] == "compute"
    t = troof.roofline_terms(0.0, 3.35e12, 0.0)
    assert t["dominant"] == "memory" and t["step_lower_bound_s"] == 1.0
    t = troof.roofline_terms(1.0, 1.0, 25e9)
    assert t["dominant"] == "collective" and t["t_collective_s"] == 1.0
    assert t["compute_fraction"] < 1e-12
