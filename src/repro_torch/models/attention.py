"""GQA attention: causal prefill + KV-cache decode.

Counterpart of ``repro.models.attention``.  Prefill attention is plain
PyTorch with explicit matmuls and a causal mask (the reference's is plain
jnp too); it keeps ``_flash_fwd``'s numerics: f32 scores, probabilities
cast to the value dtype before the PV product, f32 accumulation.  Decode
on a CUDA device goes through the hand-written ``decode_attention``
kernel whenever the reference's kernel guard holds (no sliding window, no
softcap); on the CPU it does so only when ``cfg.use_pallas_decode`` asks
for the kernel path, which there runs the kernel's plain version.

The KV cache keeps the reference's (B, S, Hkv, hd) layout and is written
in place, where the reference writes it functionally (``.at[].set`` /
``dynamic_update_slice``) and relies on buffer donation.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from .config import ModelConfig
from .layers import apply_rope, normal_init, out_proj_init

NEG_INF = -1e30


def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    p = {
        "w_q": normal_init(gen, (cfg.d_model, cfg.q_dim), dtype, device),
        "w_k": normal_init(gen, (cfg.d_model, cfg.kv_dim), dtype, device),
        "w_v": normal_init(gen, (cfg.d_model, cfg.kv_dim), dtype, device),
        "w_o": out_proj_init(gen, (cfg.q_dim, cfg.d_model), dtype, device,
                             cfg.n_layers),
    }
    if cfg.qkv_bias:
        for name, dim in (("b_q", cfg.q_dim), ("b_k", cfg.kv_dim),
                          ("b_v", cfg.kv_dim)):
            p[name] = torch.zeros((dim,), dtype=dtype, device=device)
    return p


def _project_qkv(cfg: ModelConfig, params, x, positions, compute_dtype):
    """x: (B, S, d) -> q (B,S,Hq,hd), k/v (B,S,Hkv,hd), with RoPE."""
    b, s, _ = x.shape
    x = x.to(compute_dtype)
    q = x @ params["w_q"].to(compute_dtype)
    k = x @ params["w_k"].to(compute_dtype)
    v = x @ params["w_v"].to(compute_dtype)
    if cfg.qkv_bias:
        q = q + params["b_q"].to(compute_dtype)
        k = k + params["b_k"].to(compute_dtype)
        v = v + params["b_v"].to(compute_dtype)
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _softcap(s: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(s / cap) if cap > 0 else s


def causal_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, q_positions: torch.Tensor,
                     kv_positions: torch.Tensor) -> torch.Tensor:
    """Causal GQA attention: q (B,S,Hq,hd), k/v (B,S,Hkv,hd) -> (B,S,Hq,hd).

    The whole (S, S) score block at once, with ``_flash_fwd``'s numerics.
    """
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, s, hkv, g, hd).permute(0, 2, 3, 1, 4)   # (B,Hkv,G,S,hd)
    kt = k.permute(0, 2, 1, 3)                                 # (B,Hkv,S,hd)
    vt = v.permute(0, 2, 1, 3)
    sco = torch.matmul(qg.float(), kt.float()[:, :, None].transpose(-1, -2))
    sco = _softcap(sco * hd ** -0.5, cfg.attn_logit_softcap)   # (B,Hkv,G,S,S)
    mask = q_positions[:, None, None, :, None] >= kv_positions[:, None, None, None, :]
    if cfg.sliding_window > 0:
        mask = mask & ((q_positions[:, None, None, :, None]
                        - kv_positions[:, None, None, None, :])
                       < cfg.sliding_window)
    sco = torch.where(mask, sco, torch.full_like(sco, NEG_INF))
    m = sco.amax(dim=-1, keepdim=True)
    p = torch.exp(sco - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), vt.float()[:, :, None])
    out = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)       # (B,Hkv,G,S,hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, hd)


def attention_forward(cfg: ModelConfig, params: dict, x: torch.Tensor,
                      positions: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Forward-pass self-attention (no cache)."""
    q, k, v = _project_qkv(cfg, params, x, positions, compute_dtype)
    out = causal_attention(cfg, q, k, v, positions, positions)
    b, s = x.shape[:2]
    return out.reshape(b, s, cfg.q_dim) @ params["w_o"].to(compute_dtype)


def attention_prefill(cfg: ModelConfig, params: dict, x: torch.Tensor,
                      positions: torch.Tensor, cache: dict,
                      compute_dtype) -> tuple[torch.Tensor, dict]:
    """Prefill: causal attention, and K/V written into the cache at [0, S)."""
    q, k, v = _project_qkv(cfg, params, x, positions, compute_dtype)
    out = causal_attention(cfg, q, k, v, positions, positions)
    s = x.shape[1]
    # In place; the reference's dynamic_update_slice is functional.
    cache["k"][:, :s] = k.to(cache["k"].dtype)
    cache["v"][:, :s] = v.to(cache["v"].dtype)
    b = x.shape[0]
    y = out.reshape(b, s, cfg.q_dim) @ params["w_o"].to(compute_dtype)
    return y, cache


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device) -> dict:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_decode(cfg: ModelConfig, params: dict, x: torch.Tensor,
                     pos: torch.Tensor, cache: dict,
                     compute_dtype) -> tuple[torch.Tensor, dict]:
    """One-token decode: x (B, 1, d), pos (B,) int32 current position.

    Writes k/v at ``pos`` and attends over cache[0..pos].
    """
    b = x.shape[0]
    q, k, v = _project_qkv(cfg, params, x, pos[:, None], compute_dtype)

    # In place; the reference's .at[batch, pos].set is functional and its
    # caller donates the old cache.
    rows = torch.arange(b, device=x.device)
    ck, cv = cache["k"], cache["v"]
    ck[rows, pos.long()] = k[:, 0].to(ck.dtype)
    cv[rows, pos.long()] = v[:, 0].to(cv.dtype)

    s_max = ck.shape[1]
    hkv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    qg = q.reshape(b, hkv, g, hd)
    if (cfg.use_pallas_decode or x.is_cuda) and cfg.sliding_window == 0 \
            and cfg.attn_logit_softcap == 0:
        # The kernel reads the (B, S, Hkv, hd) cache through a transposed
        # view (strides), so no copy into kernel layout is made.
        out = ops.decode_attention(
            qg.to(compute_dtype).contiguous(),
            ck.transpose(1, 2).to(compute_dtype),
            cv.transpose(1, 2).to(compute_dtype),
            pos.to(torch.int32),
        )
    else:
        kt = ck.to(compute_dtype)
        vt = cv.to(compute_dtype)
        sco = torch.einsum("bngd,bsnd->bngs", qg.float(), kt.float()) \
            * hd ** -0.5
        sco = _softcap(sco, cfg.attn_logit_softcap)
        kv_pos = torch.arange(s_max, device=x.device)[None, :]
        mask = kv_pos <= pos[:, None]
        if cfg.sliding_window > 0:
            mask = mask & ((pos[:, None] - kv_pos) < cfg.sliding_window)
        sco = torch.where(mask[:, None, None, :], sco,
                          torch.full_like(sco, NEG_INF))
        p = torch.softmax(sco, dim=-1)
        out = torch.einsum("bngs,bsnd->bngd", p.to(compute_dtype).float(),
                           vt.float())
    y = out.reshape(b, 1, cfg.q_dim).to(compute_dtype) \
        @ params["w_o"].to(compute_dtype)
    return y, cache
