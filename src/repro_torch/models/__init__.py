from repro_torch.models.transformer import Model  # noqa: F401
