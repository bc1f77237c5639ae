from repro_torch.configs.base import ArchConfig, ShapeSpec, SHAPES
from repro_torch.configs.registry import get_config, list_archs, reduced

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "get_config", "list_archs",
           "reduced"]
