"""Mixture-of-Experts layer (paper Sec. III-C) with placement-aware layout.

Counterpart of ``repro.models.moe``: softmax gate scores (Eq. 11), top-K
selection, combine weights normalized over the active set (Eq. 15), and a
sort+gather dispatch into capacity-padded (E, C, d) buckets that drops the
same token copies the reference drops.  The expert FFN runs through
``kernels.ops.expert_ffn``, i.e. the hand-written ``gmm`` kernel on a CUDA
device.  ``apply_placement`` is the SpaceMoE placement as a checkpoint
transform (permuted expert stacks and router columns).

Not ported yet (they raise): EP slotting, shared experts, and the
expert-parallel ``moe_apply_ep*`` paths.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import ops
from .config import ModelConfig
from .layers import normal_init, out_proj_init


def _check_supported(cfg: ModelConfig) -> None:
    if getattr(cfg, "moe_slotting", False):
        raise NotImplementedError("MoE EP slotting is not yet ported")
    if cfg.n_shared_experts > 0:
        raise NotImplementedError("shared experts are not yet ported")


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    _check_supported(cfg)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    return {
        "router": normal_init(gen, (d, e), torch.float32, device),  # kept f32
        "w_gate": normal_init(gen, (e, d, f), dtype, device),
        "w_up": normal_init(gen, (e, d, f), dtype, device),
        "w_down": out_proj_init(gen, (e, f, d), dtype, device, cfg.n_layers),
    }


# --------------------------------------------------------------------- #
# Routing (Eq. 11 + top-K + Eq. 15 combine weights)
# --------------------------------------------------------------------- #


def route(cfg: ModelConfig, router_w: torch.Tensor, x: torch.Tensor):
    """x: (T, d) -> (weights (T,K), idx (T,K) int64, aux dict)."""
    logits = x.float() @ router_w.float()                            # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k takes the lower index among equal values; a stable
    # descending sort keeps equal values in index order, so its first K
    # columns are the same choice.
    sorted_p, sorted_i = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
    top_p, top_i = sorted_p[:, :cfg.top_k], sorted_i[:, :cfg.top_k]
    weights = top_p / top_p.sum(dim=-1, keepdim=True)                # Eq. 15
    # Switch-style load-balance loss + router z-loss.
    e = cfg.n_experts
    me = probs.mean(dim=0)                                           # (E,)
    # scatter_add of ones (exact in f32), not bincount: bincount on a CUDA
    # tensor waits for the device to size its output.
    flat = top_i.reshape(-1)
    ce = torch.zeros(e, dtype=torch.float32, device=x.device).scatter_add_(
        0, flat, torch.ones_like(flat, dtype=torch.float32)) / top_i.numel()
    aux = {
        "load_balance_loss": e * torch.sum(me * ce),
        "router_z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
        "expert_counts": ce,
    }
    return weights, top_i, aux


# --------------------------------------------------------------------- #
# Sort + gather dispatch to capacity-padded (E, C, d) buckets
# --------------------------------------------------------------------- #


def capacity(cfg: ModelConfig, n_tokens: int, n_buckets: int) -> int:
    c = int(np.ceil(cfg.capacity_factor * n_tokens * cfg.top_k / n_buckets))
    return max(c, cfg.top_k)


def dispatch_indices(idx: torch.Tensor, n_experts: int, cap: int):
    """Compute the gather plan mapping (E, C) slots to token copies.

    idx: (T, K) expert choice per token copy.  Returns
      slot_token: (E*C,) index into the flattened (T*K,) copy list
                  (0 where unfilled),
      slot_valid: (E*C,) bool — slot actually holds a token,
      copy_slot:  (T*K,) slot of each copy (0 where dropped),
      copy_kept:  (T*K,) bool.
    Copies beyond an expert's capacity are dropped in token order, as in
    the reference.
    """
    tk = idx.numel()
    dev = idx.device
    flat = idx.reshape(-1).long()                              # (T*K,)
    order = torch.argsort(flat, stable=True)                   # sort copies by expert
    sorted_e = flat[order].contiguous()
    # position within expert = rank among same-expert copies
    pos_in_e = torch.arange(tk, device=dev) \
        - torch.searchsorted(sorted_e, sorted_e, side="left")
    kept = pos_in_e < cap
    slot_of_sorted = sorted_e * cap + pos_in_e                 # (T*K,)
    # Dropped copies target a trash slot E*C that is cut off afterwards
    # (the reference's scatter mode="drop"); no valid slot is overwritten.
    n_slots = n_experts * cap
    tgt = torch.where(kept, slot_of_sorted, torch.full_like(slot_of_sorted, n_slots))
    slot_token = torch.zeros(n_slots + 1, dtype=torch.int64, device=dev) \
        .scatter_(0, tgt, order)[:n_slots]
    slot_valid = torch.zeros(n_slots + 1, dtype=torch.bool, device=dev) \
        .scatter_(0, tgt, torch.ones_like(kept))[:n_slots]
    copy_slot = torch.zeros(tk, dtype=torch.int64, device=dev).scatter_(
        0, order, torch.where(kept, slot_of_sorted, torch.zeros_like(slot_of_sorted)))
    copy_kept = torch.zeros(tk, dtype=torch.bool, device=dev).scatter_(0, order, kept)
    return slot_token, slot_valid, copy_slot, copy_kept


def expert_ffn(params: dict, xs: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Batched SwiGLU over expert buckets through the gmm kernel:
    xs (E, C, d) -> (E, C, d)."""
    return ops.expert_ffn(params, xs, compute_dtype)


def _combine(gathered: torch.Tensor, weights: torch.Tensor, t: int, k: int,
             frag: int, compute_dtype) -> torch.Tensor:
    """(T*K*frag, d) copy outputs -> (T, d): sum fragments, weight top-K."""
    per_copy = gathered.reshape(t, k, frag, -1).sum(dim=2)
    return torch.einsum("tkd,tk->td", per_copy, weights.to(compute_dtype))


def moe_apply_local(cfg: ModelConfig, params: dict, x: torch.Tensor,
                    compute_dtype) -> tuple[torch.Tensor, dict]:
    """Single-device MoE: x (B, S, d) -> (B, S, d)."""
    _check_supported(cfg)
    b, s, d = x.shape
    t = b * s
    k = cfg.top_k
    xt = x.reshape(t, d).to(compute_dtype)
    weights, idx, aux = route(cfg, params["router"], xt)
    n_b, cap, frag = cfg.n_experts, capacity(cfg, t, cfg.n_experts), 1
    slot_token, slot_valid, copy_slot, copy_kept = dispatch_indices(idx, n_b, cap)
    # copy j of the flattened (T*K,) list is token j // K: gather the
    # tokens directly instead of materializing the repeated copies.
    buckets = xt[slot_token // (k * frag)] * slot_valid[:, None].to(compute_dtype)
    outs = expert_ffn(params, buckets.reshape(n_b, cap, d), compute_dtype)
    flat_out = outs.reshape(n_b * cap, d)
    gathered = flat_out[copy_slot] * copy_kept[:, None].to(compute_dtype)
    y = _combine(gathered, weights, t, k, frag, compute_dtype)
    return y.reshape(b, s, d), aux


# --------------------------------------------------------------------- #
# SpaceMoE placement as a checkpoint transform
# --------------------------------------------------------------------- #


def apply_placement(moe_params: dict, slot_to_expert: np.ndarray) -> dict:
    """Permute a MoE layer's weights so EP slot s hosts expert
    ``slot_to_expert[s]`` (a ``DevicePlacementPlan.expert_perm``).

    The router columns are permuted identically, so routing semantics are
    unchanged: logits[slot] == original logits[slot_to_expert[slot]].
    """
    perm = torch.as_tensor(np.asarray(slot_to_expert), dtype=torch.int64,
                           device=moe_params["router"].device)
    out = dict(moe_params)
    out["router"] = moe_params["router"][:, perm]
    for name in ("w_gate", "w_up", "w_down"):
        out[name] = moe_params[name][perm]
    return out


__all__ = ["moe_init", "route", "capacity", "dispatch_indices", "expert_ffn",
           "moe_apply_local", "apply_placement"]
