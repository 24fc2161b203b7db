"""Config registry of the port.

``get_config(arch_id)`` returns the full published config;
``smoke_config(arch_id)`` returns the same reduced config as
``repro.configs.smoke_config`` (same pattern/MoE/GQA structure, tiny dims).
Only the paper's model is registered so far; the other architectures of
the reference join with the model families that run them.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

from . import llama_moe_3p5b

_MODULES = [llama_moe_3p5b]

REGISTRY: dict[str, ModelConfig] = {m.ARCH_ID: m.CONFIG for m in _MODULES}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; the port knows "
                       f"{sorted(REGISTRY)} (other architectures not yet "
                       "ported)")
    return REGISTRY[arch_id]


def smoke_config(arch_id: str) -> ModelConfig:
    """Reduced same-family config: small width/depth, few experts, tiny
    vocab — structure (pattern, GQA ratio, shared experts, frontend,
    first-dense-layer) preserved."""
    cfg = get_config(arch_id)
    n_kv = max(1, round(4 * cfg.n_kv_heads / cfg.n_heads))
    while 4 % n_kv:
        n_kv -= 1
    units = 2 + (1 if cfg.first_layer_dense else 0)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=units * len(cfg.pattern),
        d_model=64,
        n_heads=4,
        n_kv_heads=n_kv,
        head_dim=16,
        d_ff=96 if cfg.d_ff else 0,
        d_ff_expert=32 if cfg.n_experts else 0,
        n_experts=min(cfg.n_experts, 8),
        top_k=min(cfg.top_k, 4),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        first_dense_d_ff=64 if cfg.first_layer_dense else 0,
        vocab_size=512,
        vocab_pad_multiple=16,
        mamba_dt_rank=4,
        attn_q_chunk=16,
        attn_kv_chunk=16,
        compute_dtype="float32",
    )


__all__ = ["REGISTRY", "get_config", "smoke_config"]
