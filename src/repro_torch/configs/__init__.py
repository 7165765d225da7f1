"""Architecture registry (the port's copy of ``repro.configs``): importing the
package registers all ten assigned architectures."""

from repro_torch.configs.base import (
    ArchConfig,
    ShapeConfig,
    SHAPES,
    get_arch,
    get_shape,
    list_archs,
    register_arch,
)

# importing the package registers every assigned architecture
from repro_torch.configs import (  # noqa: F401
    codeqwen15_7b,
    qwen25_32b,
    qwen2_vl_2b,
    gemma2_27b,
    glm4_9b,
    zamba2_7b,
    deepseek_v3_671b,
    arctic_480b,
    musicgen_large,
    mamba2_130m,
)

__all__ = [
    "ArchConfig",
    "ShapeConfig",
    "SHAPES",
    "get_arch",
    "get_shape",
    "list_archs",
    "register_arch",
]
