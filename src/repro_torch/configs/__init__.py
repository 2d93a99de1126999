"""Model-zoo configurations (port of ``repro/configs``)."""
from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES,
    ModelConfig,
    get_config,
    list_archs,
    register,
)
