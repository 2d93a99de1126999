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
from repro_torch.core.gossip import identity_mixer, make_dense_mixer  # noqa: F401
from repro_torch.core.hyper import Hyper, hyper_grid, n_sweep, stack_hypers  # noqa: F401
from repro_torch.core.mixing import (  # noqa: F401
    MixPlan,
    apply_mix,
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
from repro_torch.core.topology import (  # noqa: F401
    delta_coefficients,
    mixing_matrix,
    spectral_lambda,
    validate_mixing,
)
