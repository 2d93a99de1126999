"""Models of the port: the paper's classifiers and the zoo's decoder families."""
from repro_torch.models.registry import Model, build_model  # noqa: F401
