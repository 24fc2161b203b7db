"""Shared primitives: norms, initializers, rotary embeddings, FFN.

Counterpart of ``repro.models.layers``.  Weights keep the reference's
layout (``x @ w`` with ``w`` of shape ``(d_in, d_out)``), and the f32
internals of ``rmsnorm`` and ``apply_rope`` are kept as they are there.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


# --------------------------------------------------------------------- #
# Initializers (explicit generator and device; numbers differ from
# jax.random, so parity tests carry weights across with convert.py)
# --------------------------------------------------------------------- #


def normal_init(gen: torch.Generator, shape, dtype, device,
                scale: float = 0.02) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (scale * w).to(dtype)


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


def ffn_apply(params: dict, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    x = x.to(compute_dtype)
    gate = F.silu(x @ params["w_gate"].to(compute_dtype))
    up = x @ params["w_up"].to(compute_dtype)
    return (gate * up) @ params["w_down"].to(compute_dtype)


# --------------------------------------------------------------------- #
# Embedding / LM head
# --------------------------------------------------------------------- #


def embedding_init(gen, vocab: int, d_model: int, dtype, device) -> torch.Tensor:
    return normal_init(gen, (vocab, d_model), dtype, device)


def embed(table: torch.Tensor, tokens: torch.Tensor,
          compute_dtype) -> torch.Tensor:
    return table[tokens.long()].to(compute_dtype)


def lm_head(table_or_w: torch.Tensor, x: torch.Tensor,
            tied: bool) -> torch.Tensor:
    w = table_or_w.to(x.dtype)
    return x @ (w.T if tied else w)
