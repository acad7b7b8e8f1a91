from .registry import (
    CONFIGS, SHAPES, cell_enabled, cells, get_config, get_model, input_specs, make_smoke_batch,
    reduced_config,
)

__all__ = [
    "CONFIGS", "SHAPES", "cells", "cell_enabled", "get_config", "get_model",
    "input_specs", "make_smoke_batch", "reduced_config",
]
