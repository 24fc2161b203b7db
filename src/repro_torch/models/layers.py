"""Shared primitives: norms, initializers, rotary embeddings, FFN.

Counterpart of ``repro.models.layers``.  Weights keep the reference's
layout (``x @ w`` with ``w`` of shape ``(d_in, d_out)``), and the f32
internals of ``rmsnorm`` and ``apply_rope`` are kept as they are there.

Under ``par`` (``models.Parallel``) with a model axis of more than one
rank, each weight is this rank's block (``distributed.sharding``) and
these functions compute its part, Megatron's way: ``ffn_apply`` takes
gate and up by column and down by row, then sums over the axis;
``embed`` looks up the rank's vocab rows (zeros for the other tokens)
and sums; ``lm_head`` gives the rank's vocab columns of the logits.  A
width that does not divide the axis is held whole and computed whole,
as the rules replicate it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..distributed.collectives import copy_to, reduce_from


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


# --------------------------------------------------------------------- #
# Initializers (explicit generator and device; numbers differ from
# jax.random, so parity tests carry weights across with convert.py)
# --------------------------------------------------------------------- #


# Set by ``model.init_params`` while it draws a rank's blocks: each drawn
# weight goes through it as soon as it is made (and is replaced by what
# it returns), so that no two whole weights are held at once.
leaf_hook = None


def normal_init(gen: torch.Generator, shape, dtype, device,
                scale: float = 0.02) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    w = w.mul_(scale).to(dtype)        # in place: one f32 copy at a time
    return w if leaf_hook is None else leaf_hook(w)


def out_proj_init(gen: torch.Generator, shape, dtype, device, n_layers: int,
                  scale: float = 0.02) -> torch.Tensor:
    """GPT-2 style residual-branch scaling."""
    return normal_init(gen, shape, dtype, device,
                       scale / math.sqrt(2 * n_layers))


# --------------------------------------------------------------------- #
# RMSNorm (f32 internals)
# --------------------------------------------------------------------- #


def rmsnorm_init(d: int, device) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    orig = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(orig)


# --------------------------------------------------------------------- #
# Rotary position embeddings (f32 angles, cast back to x.dtype)
# --------------------------------------------------------------------- #


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), float32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate q/k.  x: (..., seq, n_heads, head_dim); positions: (..., seq)."""
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, x.device)       # (half,)
    angles = positions[..., :, None].float() * freqs              # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                         # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


# --------------------------------------------------------------------- #
# Gated FFN (SwiGLU)
# --------------------------------------------------------------------- #


def ffn_init(gen, d_model: int, d_ff: int, n_layers: int, dtype,
             device) -> dict:
    return {
        "w_gate": normal_init(gen, (d_model, d_ff), dtype, device),
        "w_up": normal_init(gen, (d_model, d_ff), dtype, device),
        "w_down": out_proj_init(gen, (d_ff, d_model), dtype, device,
                                n_layers),
    }


def ffn_apply(params: dict, x: torch.Tensor, compute_dtype, par=None,
              width: int = 0) -> torch.Tensor:
    """SwiGLU; ``width`` is the global hidden width, which decides whether
    ``par`` splits it (module docstring)."""
    x = x.to(compute_dtype)
    tp = par is not None and par.split(width)
    if tp:
        x = copy_to(x, par.model_group())
    gate = F.silu(x @ params["w_gate"].to(compute_dtype))
    up = x @ params["w_up"].to(compute_dtype)
    y = (gate * up) @ params["w_down"].to(compute_dtype)
    return reduce_from(y, par.model_group()) if tp else y


# --------------------------------------------------------------------- #
# Embedding / LM head
# --------------------------------------------------------------------- #


def embedding_init(gen, vocab: int, d_model: int, dtype, device) -> torch.Tensor:
    return normal_init(gen, (vocab, d_model), dtype, device)


def embed(table: torch.Tensor, tokens: torch.Tensor, compute_dtype,
          par=None, vocab: int = 0) -> torch.Tensor:
    """Rows of ``table`` for ``tokens``; under ``par`` splitting ``vocab``
    the table is the rank's rows, and every token's row comes from the
    one rank that holds it (the others add zeros, so the sum is exact)."""
    if par is None or not par.split(vocab):
        return table[tokens.long()].to(compute_dtype)
    rows = table.shape[0]
    local = tokens.long() - par.model_rank() * rows
    inside = (local >= 0) & (local < rows)
    x = table[torch.where(inside, local, torch.zeros_like(local))] \
        * inside[..., None].to(table.dtype)
    return reduce_from(x.to(compute_dtype), par.model_group())


def lm_head(table_or_w: torch.Tensor, x: torch.Tensor, tied: bool,
            par=None, vocab: int = 0) -> torch.Tensor:
    """Logits; under ``par`` splitting ``vocab``, the rank's columns."""
    w = table_or_w.to(x.dtype)
    if par is not None and par.split(vocab):
        x = copy_to(x, par.model_group())
    return x @ (w.T if tied else w)
