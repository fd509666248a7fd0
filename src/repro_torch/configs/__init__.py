"""The architecture configs, copied from `repro/configs/`; `get_arch` and
`get_reduced` resolve inside the port."""
from repro_torch.configs.base import (ARCH_IDS, EXTRA_ARCH_IDS, SHAPES,
                                      ArchConfig, MLAConfig, MoEConfig,
                                      RGLRUConfig, SSMConfig, ShapeSpec,
                                      cells, get_arch, get_reduced)

__all__ = [
    "ARCH_IDS", "EXTRA_ARCH_IDS", "SHAPES", "ArchConfig", "MLAConfig",
    "MoEConfig", "RGLRUConfig", "SSMConfig", "ShapeSpec", "cells",
    "get_arch", "get_reduced",
]
