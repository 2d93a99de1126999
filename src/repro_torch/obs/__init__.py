from repro_torch.obs.trace import (  # noqa: F401
    PHASES,
    RoundTimer,
    Timing,
    annotate,
    block_until_ready,
    profile_capture,
    time_fn,
)
