"""Host-side analysis: bytes on the wire of (compressed) gossip rounds,
and the three-term roofline over the card's hardware model.

``hlo`` (collective bytes parsed from XLA's HLO) waits for the distributed
backends (ROADMAP Queue 1 item 5c): collectives need a process group.
"""
from repro_torch.analysis.comm import (  # noqa: F401
    collectives_per_round,
    device_wire_bytes,
    payload_row_bytes,
    round_edges,
    round_wire_bytes,
    spec_bits_per_coord,
    sweep_round_bytes,
)
from repro_torch.analysis.roofline import (  # noqa: F401
    fused_sweep_roofline,
    fused_sweep_traffic,
    model_flops,
    roofline_terms,
)
