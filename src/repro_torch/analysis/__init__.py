"""Host-side analysis: bytes on the wire of (compressed) gossip rounds,
the three-term roofline over the card's hardware model, and the
collectives a sharded run put on the wire (``hlo``: counted as they run,
where the reference parses XLA's HLO).
"""
from repro_torch.analysis.hlo import (  # noqa: F401
    collective_bytes,
    parse_collectives,
)
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
