from .registry import CONFIGS, get_config, get_model, reduced_config

__all__ = ["CONFIGS", "get_config", "get_model", "reduced_config"]
