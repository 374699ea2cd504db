from .adamw import AdamWConfig  # noqa: F401
