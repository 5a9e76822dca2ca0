"""repro_torch.configs — the port's copy of the model configurations."""

from repro_torch.configs.base import (
    ARCH_ALIASES,
    ARCH_IDS,
    PORTED_ARCHS,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    cells,
    get_config,
    get_smoke_config,
)

__all__ = ["ARCH_ALIASES", "ARCH_IDS", "PORTED_ARCHS", "SHAPES", "ModelConfig",
           "ShapeConfig", "cells", "get_config", "get_smoke_config"]
