from .base import (ARCH_NAMES, SHAPES, ArchConfig, LayerSpec, Segment, ShapeSpec,  # noqa: F401
                   all_configs, get_config)
