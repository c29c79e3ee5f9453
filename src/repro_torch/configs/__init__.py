"""Architecture configs: the published configurations of the JAX
package, copied as data (``ArchConfig``, ``get_config``,
``get_smoke_config``)."""
from .base import (ARCH_IDS, SHAPES, ArchConfig, ShapeSpec, get_config,
                   get_smoke_config, shape_applicable)

__all__ = ["ARCH_IDS", "SHAPES", "ArchConfig", "ShapeSpec", "get_config",
           "get_smoke_config", "shape_applicable"]
