"""Step functions (counterpart of ``repro.launch.steps``; serve step only)."""
from __future__ import annotations

import torch

from ..models import decode_step
from ..models.config import ModelConfig


def make_serve_step(cfg: ModelConfig):
    """One decode step: greedy next token + logits, cache updated in place.

    ``embeds`` (B, 1, d) feeds the stub audio frontend in place of the
    tokens, as the reference's positional ``embeds`` argument does; pass
    None (the default) for token-input architectures.
    """

    def serve_step(params, cache, tokens, pos, embeds=None):
        logits, cache = decode_step(cfg, params, cache, tokens, pos,
                                    embeds=embeds)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_tok, logits, cache

    return serve_step
