from .common import ArchConfig
from .transformer import DecoderLM

__all__ = ["ArchConfig", "DecoderLM"]
