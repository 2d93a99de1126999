from repro_torch.obs.trace import PHASES, annotate  # noqa: F401
