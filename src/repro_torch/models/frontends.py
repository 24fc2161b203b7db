"""Random test inputs (counterpart of ``repro.models.frontends.random_batch``).

Drawn with numpy's generator in the reference's order, so the port gets
the reference's tokens exactly.  Token inputs only: the stub
vision/audio frontends are not yet ported.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from .config import ModelConfig


def random_batch(cfg: ModelConfig, batch: int, seq_len: int, seed: int = 0,
                 device="cuda") -> dict:
    """{"tokens": (B, S) int32, "labels": (B, S) int32} on ``device``."""
    if cfg.frontend:
        raise NotImplementedError(
            f"{cfg.frontend!r} frontend inputs are not yet ported")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq_len))
    labels = rng.integers(0, cfg.vocab_size, (batch, seq_len))
    return {
        "tokens": torch.as_tensor(tokens, dtype=torch.int32, device=dev),
        "labels": torch.as_tensor(labels, dtype=torch.int32, device=dev),
    }
