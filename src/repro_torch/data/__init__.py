from repro_torch.data.pipeline import DataConfig, DataPipeline  # noqa: F401
