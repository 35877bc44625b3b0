"""Per-architecture configs; ``get_config(arch_id)`` loads by module name."""
from repro_torch.configs.base import (ARCH_IDS, SHAPES, SUBQUADRATIC,
                                      ModelConfig, ShapeCase, all_configs,
                                      cells_for, get_config)

__all__ = ["ARCH_IDS", "SHAPES", "SUBQUADRATIC", "ModelConfig", "ShapeCase",
           "all_configs", "cells_for", "get_config"]
