"""Host-side analysis: bytes on the wire of (compressed) gossip rounds.

``roofline`` and ``hlo`` come with the launch-and-analysis slice (ROADMAP
Queue 1 item 11).
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
