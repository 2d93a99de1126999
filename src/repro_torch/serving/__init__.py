from repro_torch.serving.serve import BatchedServer, ServeConfig  # noqa: F401
