from repro_torch.data.dirichlet import (  # noqa: F401
    dirichlet_partition,
    label_proportions,
)
from repro_torch.data.synthetic import (  # noqa: F401
    SyntheticClassification,
    SyntheticTokenStream,
    make_classification,
    make_federated_lm_streams,
)
