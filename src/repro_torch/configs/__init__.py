from .base import ArchConfig, SHAPES, all_configs, get_config, register  # noqa: F401
