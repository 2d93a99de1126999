"""The card's hardware model, and the mesh builders (port of
``repro/launch/mesh.py``).

``HW`` describes one NVIDIA H100 SXM under the reference's keys, so that
:func:`repro_torch.analysis.roofline.roofline_terms` reads it as the
reference reads its TPU v5e entry, plus ``peak_flops_fp32`` for the fp32
kernels' bounds (``chip_smoke.py`` reads all four).  The rates are
NVIDIA's H100 SXM datasheet's, dense, at the full 700 W power limit.

The mesh builders need a process group over several cards, which the
port does not have yet: they raise, naming ROADMAP Queue 1 item 5c.
"""
from __future__ import annotations

# NVIDIA H100 SXM, per card
HW = {
    "peak_flops_bf16": 989e12,   # FLOP/s, tensor cores, dense
    "hbm_bandwidth": 3.35e12,    # B/s, HBM3
    # B/s, one NVLink 4 link one way (conservative single link): 18 links
    # carry the datasheet's 900 GB/s, 450 GB/s each way
    "ici_bandwidth": 25e9,
    "peak_flops_fp32": 67e12,    # FLOP/s, outside the tensor cores
}


def _needs_process_group(name: str):
    raise NotImplementedError(
        f"{name}: a device mesh needs a torch.distributed process group "
        "over several cards, which arrives with the distributed backends "
        "(ROADMAP Queue 1 item 5c)")


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh; raises until item 5c."""
    _needs_process_group("make_production_mesh")


def make_host_mesh(data: int = 1, model: int = 1):
    """The reference's small mesh over the local devices; raises until
    item 5c."""
    _needs_process_group("make_host_mesh")
