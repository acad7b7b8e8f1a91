from .registry import CONFIGS, get_config, get_model, make_smoke_batch, reduced_config

__all__ = ["CONFIGS", "get_config", "get_model", "make_smoke_batch", "reduced_config"]
