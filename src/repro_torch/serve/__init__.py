from .decode import generate, sample

__all__ = ["generate", "sample"]
