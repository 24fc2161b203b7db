"""Synthetic token pipeline (counterpart of ``repro.data``)."""
from .pipeline import DataConfig, SyntheticTokens, make_batch

__all__ = ["DataConfig", "SyntheticTokens", "make_batch"]
