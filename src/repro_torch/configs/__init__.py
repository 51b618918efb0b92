"""Configurations of the port: the event workload (``geps_events``) and
copies of the JAX package's architecture configs (``registry``)."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    ShapeConfig,
    SHAPES,
    pad_to_multiple,
)
from repro_torch.configs.registry import (  # noqa: F401
    get_config,
    list_archs,
    reduced_config,
)
