from repro_torch.core.fedopt.baselines import (  # noqa: F401
    ALGORITHMS,
    FedAlgConfig,
    FedState,
    make_algorithm,
)
