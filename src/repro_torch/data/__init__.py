from .pipeline import DataConfig, SyntheticPipeline  # noqa: F401
