"""Step functions (counterpart of ``repro.launch.steps``; serve step only)."""
from __future__ import annotations

import torch

from ..models import decode_step
from ..models.config import ModelConfig


def make_serve_step(cfg: ModelConfig):
    """One decode step: greedy next token + logits, cache updated in place.

    Token inputs only (the reference's ``embeds`` argument serves the stub
    audio frontend, which is not yet ported).
    """

    def serve_step(params, cache, tokens, pos):
        logits, cache = decode_step(cfg, params, cache, tokens, pos)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_tok, logits, cache

    return serve_step
