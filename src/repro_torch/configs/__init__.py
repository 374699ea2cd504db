from .base import SHAPES, ArchConfig, LayerSpec, Segment, ShapeSpec, get_config  # noqa: F401
