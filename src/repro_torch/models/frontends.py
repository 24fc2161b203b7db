"""Stub modality frontends (counterpart of ``repro.models.frontends``).

The vision and audio architectures specify the transformer backbone
only; the modality encoder (CLIP tower / EnCodec) is a stub whose output,
precomputed patch or frame embeddings, is an input of the model.  These
helpers give the split of a sequence into embeddings and text tokens,
meta-device stand-ins for a batch (where the reference returns
``ShapeDtypeStruct``s), and random inputs drawn with numpy's generator in
the reference's order, so the port gets the reference's batch exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from .config import ModelConfig

# llava-next anyres: one 24x24 base tile + CLS drop => 576 patch embeddings.
VISION_TOKENS = 576


def frontend_split(cfg: ModelConfig, seq_len: int) -> tuple[int, int]:
    """(n_embed_tokens, n_text_tokens) summing to seq_len."""
    if cfg.frontend == "vision":
        n_emb = min(VISION_TOKENS, seq_len // 2)
        return n_emb, seq_len - n_emb
    if cfg.frontend == "audio":
        return seq_len, 0        # decoder over EnCodec frames only
    return 0, seq_len


def batch_specs(cfg: ModelConfig, batch: int, seq_len: int,
                embed_dtype=torch.bfloat16) -> dict:
    """Meta-device tensors for a batch (tokens/embeds + labels)."""
    n_emb, n_text = frontend_split(cfg, seq_len)
    out: dict = {}
    if n_emb:
        out["embeds"] = torch.empty((batch, n_emb, cfg.d_model),
                                    dtype=embed_dtype, device="meta")
    if n_text:
        out["tokens"] = torch.empty((batch, n_text), dtype=torch.int32,
                                    device="meta")
    out["labels"] = torch.empty((batch, seq_len), dtype=torch.int32,
                                device="meta")
    return out


def random_batch(cfg: ModelConfig, batch: int, seq_len: int, seed: int = 0,
                 embed_dtype=torch.bfloat16, device="cuda") -> dict:
    """Random inputs on ``device``: "embeds" (B, S_e, d) in ``embed_dtype``
    where the frontend takes embeddings, "tokens" (B, S_t) int32 where
    there is text, and "labels" (B, S) int32 (-1 over an image prefix).

    Draws in the reference's order: normal embeddings, token ids, labels.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_emb, n_text = frontend_split(cfg, seq_len)
    out: dict = {}
    if n_emb:
        draws = rng.normal(0, 1, (batch, n_emb, cfg.d_model))
        # Through f32, as ``jnp.asarray(draws, dtype=bfloat16)`` rounds:
        # an f64 just off an f32 tie of two bf16 values rounds to even
        # there, where a direct f64 rounding would not.
        out["embeds"] = torch.from_numpy(draws.astype(np.float32)) \
            .to(embed_dtype).to(dev)
    if n_text:
        out["tokens"] = torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (batch, n_text)),
            dtype=torch.int32, device=dev)
    labels = rng.integers(0, cfg.vocab_size, (batch, seq_len))
    if n_emb and cfg.frontend == "vision":
        labels[:, :n_emb] = -1   # no next-token loss on the image prefix
    # (audio: the EnCodec frames are stubbed as input embeddings, but the
    # codec token ids remain the prediction targets.)
    out["labels"] = torch.as_tensor(labels, dtype=torch.int32, device=dev)
    return out
