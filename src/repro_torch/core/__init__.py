"""Paper core: DEPOSITUM and its composite-optimization substrate."""
from repro_torch.core.depositum import (  # noqa: F401
    DepositumConfig,
    DepositumState,
    consensus_error,
    fused_eligibility,
    init,
    local_then_comm_round,
    stationarity_metrics,
    step,
)
from repro_torch.core.cohort import (  # noqa: F401
    CohortSampler,
    pad_plan,
    stack_cohorts,
)
from repro_torch.core.compression import (  # noqa: F401
    CommMemory,
    CompressionSpec,
    active_compression,
    as_mixed,
    choco_mix,
    comm_memory,
    comm_round_keys,
    compress,
    compression_of,
    pack_payload,
    stack_specs,
    unpack_payload,
    wire_mode,
)
from repro_torch.core.gossip import (  # noqa: F401
    circulant_from_mixer_spec,
    identity_mixer,
    make_complete_mixer,
    make_dense_mixer,
    make_neighbor_mixer,
    ring_mixer,
    torus_circulant_spec,
    torus_grid_shape,
    torus_mixer,
)
from repro_torch.core.hyper import Hyper, hyper_grid, n_sweep, stack_hypers  # noqa: F401
from repro_torch.core.mixing import (  # noqa: F401
    MixPlan,
    apply_mix,
    apply_mix_sweep,
    as_dense,
    as_mixer,
    plan_spectral_lambda,
    resolve_mixer,
    stack_mixplans,
    validate_plan,
)
from repro_torch.core.prox import (  # noqa: F401
    ProxFamily,
    ProxOperator,
    get_family,
    get_prox,
    prox_apply,
    prox_gradient,
)
from repro_torch.core.staleness import (  # noqa: F401
    StalenessPolicy,
    StragglerModel,
    check_bounded_staleness,
    replay_cohorts,
    replay_staleness,
    sync_virtual_time,
)
from repro_torch.core.schedule import (  # noqa: F401
    MixSchedule,
    ScheduleMixer,
    apply_schedule,
    apply_schedule_sweep,
    as_schedule,
    as_stacked_schedule,
    schedule_round_mask,
    schedule_spectral_lambda,
    stack_schedules,
    validate_schedule,
)
from repro_torch.core.topology import (  # noqa: F401
    delta_coefficients,
    mixing_matrix,
    spectral_lambda,
    validate_mixing,
)
