"""Composable LM: init / forward / prefill / decode_step.

Counterpart of ``repro.models.model`` for ``attn`` mixers with dense or
MoE FFNs.  The reference scans over stacked pattern units; here the
parameters are a list of per-layer dicts (``params["layers"][i]`` is
block ``i % len(pattern)`` of unit ``i // len(pattern)``) and the stack is
a Python loop.  The decode cache is a matching list of per-layer KV
caches, updated in place.

Dtypes: weights are initialised in ``cfg.param_dtype`` as in the
reference, which casts each weight to ``cfg.compute_dtype`` at every use.
``cast_for_compute`` makes that cast once, at load: the values are
identical, and a decode step then reads each weight once in the compute
dtype instead of re-reading and re-casting the f32 copy.  The router and
the norm scales stay f32, as the reference uses them in f32.

Not yet ported (they raise): ``Parallel``/sharded execution, mamba /
mlstm / slstm mixers, the first-dense-layer variant, ``loss_fn`` and
``remat``.
"""
from __future__ import annotations

import torch

from .. import resolve_device
from . import attention as attn
from . import moe as moe_mod
from .config import LayerSpec, ModelConfig
from .layers import (dtype_of, embed, embedding_init, ffn_apply, ffn_init,
                     lm_head, normal_init, rmsnorm, rmsnorm_init)

# Parameters the reference keeps and uses in f32 whatever the dtypes.
F32_LEAVES = ("router", "scale")


def check_supported(cfg: ModelConfig) -> None:
    for spec in cfg.pattern:
        if spec.mixer != "attn":
            raise NotImplementedError(f"{spec.mixer} mixers are not yet ported")
        if spec.ffn not in ("dense", "moe"):
            raise NotImplementedError(f"ffn={spec.ffn!r} is not yet ported")
    if cfg.first_layer_dense:
        raise NotImplementedError("first_layer_dense is not yet ported")
    if cfg.frontend:
        raise NotImplementedError(f"{cfg.frontend!r} frontend is not yet ported")


def layer_specs(cfg: ModelConfig) -> list[LayerSpec]:
    return [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]


# ===================================================================== #
# Parameter init
# ===================================================================== #


def _block_init(gen, cfg: ModelConfig, spec: LayerSpec, dtype, device) -> dict:
    p = {"norm1": rmsnorm_init(cfg.d_model, device),
         "mixer": attn.attn_init(gen, cfg, dtype, device),
         "norm2": rmsnorm_init(cfg.d_model, device)}
    if spec.ffn == "dense":
        p["ffn"] = ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.n_layers, dtype,
                            device)
    else:
        p["ffn"] = moe_mod.moe_init(gen, cfg, dtype, device)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device="cuda") -> dict:
    """Random weights in ``cfg.param_dtype`` on ``device``.

    ``generator`` must live on ``device``; None seeds one with 0.
    """
    check_supported(cfg)
    dev = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    dtype = dtype_of(cfg.param_dtype)
    params: dict = {
        "embed": embedding_init(gen, cfg.padded_vocab, cfg.d_model, dtype, dev),
        "final_norm": rmsnorm_init(cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = normal_init(gen, (cfg.d_model, cfg.padded_vocab),
                                     dtype, dev)
    params["layers"] = [_block_init(gen, cfg, spec, dtype, dev)
                        for spec in layer_specs(cfg)]
    return params


def cast_for_compute(cfg: ModelConfig, params):
    """Cast every weight except the router and norm scales to the compute
    dtype, once (see the module docstring); tensors are replaced one by
    one, so peak memory grows by one tensor, not by a copy of the model."""
    cdt = dtype_of(cfg.compute_dtype)

    def walk(node, name=""):
        if isinstance(node, dict):
            for k in list(node):
                node[k] = walk(node[k], k)
            return node
        if isinstance(node, list):
            for i in range(len(node)):
                node[i] = walk(node[i], name)
            return node
        return node if name in F32_LEAVES else node.to(cdt)

    return walk(params)


# ===================================================================== #
# Block application (forward / prefill / decode share this)
# ===================================================================== #


def _apply_block(cfg, spec, bp, x, positions, cdt, cache, mode):
    """Returns (x, cache, aux); aux is the MoE router's aux dict or None."""
    aux = None
    h = rmsnorm(bp["norm1"], x, cfg.norm_eps)
    if mode == "forward":
        y = attn.attention_forward(cfg, bp["mixer"], h, positions, cdt)
    elif mode == "prefill":
        y, cache = attn.attention_prefill(cfg, bp["mixer"], h, positions,
                                          cache, cdt)
    else:
        y, cache = attn.attention_decode(cfg, bp["mixer"], h, positions,
                                         cache, cdt)
    x = x + y
    h = rmsnorm(bp["norm2"], x, cfg.norm_eps)
    if spec.ffn == "dense":
        x = x + ffn_apply(bp["ffn"], h, cdt)
    else:
        out, aux = moe_mod.moe_apply_local(cfg, bp["ffn"], h, cdt)
        x = x + out
    return x, cache, aux


def _embed_inputs(cfg, params, batch, cdt):
    """batch: dict with 'tokens' (B, S)."""
    if "embeds" in batch:
        raise NotImplementedError("embedding inputs are not yet ported")
    x = embed(params["embed"], batch["tokens"], cdt)
    b, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None] \
        .expand(b, s)
    return x, positions


def _logits(cfg, params, x):
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["head"]
    return lm_head(table, x, cfg.tie_embeddings)


# ===================================================================== #
# Full passes
# ===================================================================== #


def forward(cfg: ModelConfig, params: dict, batch: dict,
            return_router_stats: bool = False):
    """Forward pass: returns (logits (B,S,V_padded), aux_loss).

    With ``return_router_stats`` also returns per-unit expert-selection
    counts (n_units, n_experts): the activation statistics that feed the
    SpaceMoE placement planner (Eq. 14 plug-in).
    """
    cdt = dtype_of(cfg.compute_dtype)
    x, positions = _embed_inputs(cfg, params, batch, cdt)
    n_e = max(cfg.n_experts, 1)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    counts = torch.zeros((cfg.n_units, n_e), dtype=torch.float32,
                         device=x.device)
    width = len(cfg.pattern)
    for i, (spec, bp) in enumerate(zip(layer_specs(cfg), params["layers"])):
        x, _, aux = _apply_block(cfg, spec, bp, x, positions, cdt, None,
                                 "forward")
        if aux is not None:
            aux_total = aux_total + aux["load_balance_loss"] \
                + 1e-3 * aux["router_z_loss"]
            counts[i // width] += aux["expert_counts"]
    logits = _logits(cfg, params, x)
    if return_router_stats:
        return logits, aux_total, counts
    return logits, aux_total


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> dict:
    """Decode cache: one KV cache per layer, in the compute dtype."""
    check_supported(cfg)
    dev = resolve_device(device)
    cdt = dtype_of(cfg.compute_dtype)
    return {"layers": [attn.init_kv_cache(cfg, batch, max_len, cdt, dev)
                       for _ in range(cfg.n_layers)]}


def prefill(cfg: ModelConfig, params: dict, batch: dict, max_len: int):
    """Run the prompt through the stack: (last-token logits (B, V), cache).

    Attention blocks write K/V for positions [0, S).
    """
    cdt = dtype_of(cfg.compute_dtype)
    x, positions = _embed_inputs(cfg, params, batch, cdt)
    cache = init_cache(cfg, x.shape[0], max_len, x.device)
    for spec, bp, lc in zip(layer_specs(cfg), params["layers"],
                            cache["layers"]):
        x, _, _ = _apply_block(cfg, spec, bp, x, positions, cdt, lc,
                               "prefill")
    logits = _logits(cfg, params, x[:, -1:, :])
    return logits[:, 0, :], cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, pos: torch.Tensor):
    """One autoregressive step; updates ``cache`` in place.

    tokens: (B, 1) int32; pos: (B,) int32 positions of these tokens.
    Returns (logits (B, V), cache).
    """
    cdt = dtype_of(cfg.compute_dtype)
    x = embed(params["embed"], tokens, cdt)
    for spec, bp, lc in zip(layer_specs(cfg), params["layers"],
                            cache["layers"]):
        x, _, _ = _apply_block(cfg, spec, bp, x, pos, cdt, lc, "decode")
    logits = _logits(cfg, params, x)
    return logits[:, 0, :], cache
