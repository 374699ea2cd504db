from .base import ArchConfig, LayerSpec, Segment, get_config  # noqa: F401
