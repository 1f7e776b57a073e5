from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset  # noqa: F401
