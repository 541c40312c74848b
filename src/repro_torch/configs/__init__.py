"""Model configurations: ``ModelConfig``, ``ShapeConfig`` and the ten
architectures of ``repro.configs`` (``get_config``, ``reduced_config``)."""

from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    ShapeConfig,
    shape_applicable,
)
from repro_torch.configs.registry import (  # noqa: F401
    ARCHS,
    get_config,
    reduced_config,
)
