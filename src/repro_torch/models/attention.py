"""GQA attention: chunked (flash-style) prefill + KV-cache decode.

Counterpart of ``repro.models.attention``.  Forward and prefill run
``flash_attention``, the reference's online softmax over
``attn_q_chunk`` x ``attn_kv_chunk`` blocks (``_flash_fwd``), so the
S x S score matrix is never materialized: f32 scores, running max, sum
and accumulator, probabilities cast to the value dtype before the PV
product.  It is plain PyTorch, as the reference's is plain jnp.  Its
backward is autograd through ``_flash_fwd`` (the reference's scan-AD),
or with ``cfg.flash_vjp`` the reference's custom VJP, ``_flash_vjp_fn``:
probabilities recomputed chunk by chunk from the saved log-sum-exp, so
no (qc, kc) block is kept for the backward.  Decode on a CUDA
device (and on ``meta``, where the dry run counts the card's program)
goes through the hand-written ``decode_attention`` kernel whenever the
reference's kernel guard holds (no sliding window, no softcap); on the
CPU it does so only when ``cfg.use_pallas_decode`` asks for the kernel
path, which there runs the kernel's plain version.  The chunk loops
iterate ``counting.steps``: a dry-run count runs the first, one
middle and the last chunk of each loop and multiplies the middle one.

The KV cache keeps the reference's (B, S, Hkv, hd) layout and is written
in place, where the reference writes it functionally (``.at[].set`` /
``dynamic_update_slice``) and relies on buffer donation.

Tensor parallelism (``par`` with a model axis of M > 1 ranks, weights
held as the rank's blocks; ``Heads`` says which case holds):
  * the q, k and v projections take the rank's column blocks;
  * where the q heads divide M and a rank's q heads lie in whole KV
    groups (or within one), attention runs on the rank's heads only,
    with the KV heads they map to;
  * a column block that is not whole heads (the k/v of every GQA arch
    whose KV heads do not divide M, the q of an arch whose heads do
    not) is gathered over the axis first; where the q heads do not
    divide, attention then runs on all heads on every rank;
  * the cache is held as ``cache_spec`` says: the rank's KV heads where
    they divide M, else all of them (each rank writes them all); decode
    reads a strided view of the heads the rank's q heads map to;
  * ``w_o`` takes the rank's rows, then the output is summed over the
    axis.

Context parallelism (``par.cp``: a whole batch, the cache's sequence
split over the data axes, as ``ShardingRules.cache_spec`` splits a
batch-1 cache): the rank holds rows [s0, s0 + S_loc) of the cache.
Prefill writes the prompt's rows that fall in its block; decode writes
the new row only on the rank that owns ``pos``, computes the softmax
partial of its block (``decode_attention``'s partial mode, or the same
in plain PyTorch on the einsum path: the normalized output and the
log-sum-exp, f32) and combines the ranks' partials (``_combine``).
"""
from __future__ import annotations

import functools

import torch

from ..distributed.collectives import (all_max, all_reduce, copy_to,
                                      gather_from, reduce_from, split_to)
from ..kernels import ops
from ..counting import pad, steps
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


class Heads:
    """How attention splits over ``par``'s model axis (module docstring).

    q_split / kv_split: the w_q / w_k, w_v columns are split (their width
    divides M); local: the rank attends with its q heads only; cache_heads:
    the cache (and k, v) hold the rank's KV heads.  kv0, n_kv: the KV
    heads the rank's q heads map to, in the k/v the rank computes (all
    heads, unless ``cache_heads``).  Without a split every flag is off and
    the rank computes everything."""

    def __init__(self, cfg: ModelConfig, par=None):
        m = par.model_size if par is not None else 1
        self.par, self.tp = par, m > 1
        hq, hkv = cfg.n_heads, cfg.n_kv_heads
        g = hq // hkv
        self.q_split = self.tp and cfg.q_dim % m == 0
        self.kv_split = self.tp and cfg.kv_dim % m == 0
        self.cache_heads = self.tp and hkv % m == 0
        per = hq // m
        self.local = self.tp and hq % m == 0 and (g % per == 0 or per % g == 0)
        self.hq = per if self.local else hq
        if not self.local:
            self.kv0, self.n_kv = 0, hkv
        elif self.cache_heads:
            self.kv0, self.n_kv = 0, hkv // m
        else:
            self.n_kv = max(1, per // g)
            self.kv0 = par.model_rank() * per // g


def _proj(x, xf, params, w: str, b: str, split: bool, cfg, cdt):
    """One projection: the rank's columns from ``xf`` (the input whose
    grad is summed over the axis) where ``split``, else whole from ``x``."""
    y = (xf if split else x) @ params[w].to(cdt)
    if cfg.qkv_bias:
        y = y + params[b].to(cdt)
    return y


def _project_qkv(cfg: ModelConfig, params, x, positions, compute_dtype,
                 heads: Heads | None = None):
    """x: (B, S, d) -> q (B,S,Hq,hd), k/v (B,S,Hkv,hd), with RoPE.  Under
    ``heads`` q holds the heads the rank attends with, k/v the KV heads
    it writes to the cache (all of them unless ``heads.cache_heads``)."""
    b, s, _ = x.shape
    h = heads or Heads(cfg)
    x = x.to(compute_dtype)
    xf = x
    if h.q_split or h.kv_split:
        xf = copy_to(x, h.par.model_group())
    q = _proj(x, xf, params, "w_q", "b_q", h.q_split, cfg, compute_dtype)
    k = _proj(x, xf, params, "w_k", "b_k", h.kv_split, cfg, compute_dtype)
    v = _proj(x, xf, params, "w_v", "b_v", h.kv_split, cfg, compute_dtype)
    if h.q_split and not h.local:
        q = gather_from(q, -1, h.par.model_group())
    if h.kv_split and not h.cache_heads:
        k = gather_from(k, -1, h.par.model_group())
        v = gather_from(v, -1, h.par.model_group())
    q = q.reshape(b, s, h.hq, cfg.head_dim)
    k = k.reshape(b, s, -1, cfg.head_dim)
    v = v.reshape(b, s, -1, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attended(h: Heads, k: torch.Tensor, v: torch.Tensor):
    """The KV heads the rank's q heads read: all of ``k``/``v`` unless the
    rank attends with its own q heads out of KV heads every rank holds
    (then its heads' slice, whose grad is summed over the axis)."""
    if not h.local or h.cache_heads:
        return k, v
    group = h.par.model_group()
    return (copy_to(k, group).narrow(2, h.kv0, h.n_kv),
            copy_to(v, group).narrow(2, h.kv0, h.n_kv))


def _out_proj(h: Heads, cfg: ModelConfig, params, out: torch.Tensor, cdt):
    """(B, S, Hq_held * hd) -> (B, S, d): the rank's rows of ``w_o``
    (its heads, or its block of all heads' columns), summed over the
    axis; whole where ``w_o``'s rows are not split."""
    if not h.q_split:
        return out @ params["w_o"].to(cdt)
    group = h.par.model_group()
    if not h.local:
        out = split_to(out, -1, group)
    return reduce_from(out @ params["w_o"].to(cdt), group)


def _softcap(s: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(s / cap) if cap > 0 else s


def _pick_chunk(s: int, target: int) -> int:
    """Largest divisor of ``s`` that is <= target."""
    c = min(target, s)
    while s % c:
        c -= 1
    return c


def flash_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, q_positions: torch.Tensor,
                    kv_positions: torch.Tensor) -> torch.Tensor:
    """Causal online-softmax attention, chunked along both S axes:
    q (B,S,Hq,hd), k/v (B,S,Hkv,hd), positions (B,S) -> (B,S,Hq,hd).

    With ``cfg.flash_vjp`` the backward is ``_flash_vjp_fn``'s; otherwise
    autograd differentiates ``_flash_fwd``.
    """
    if cfg.flash_vjp:
        out, _ = _flash_vjp_fn(cfg)(q, k, v, q_positions, kv_positions)
        return out
    out, _ = _flash_fwd(cfg, q, k, v, q_positions, kv_positions)
    return out


def _mask_block(cfg: ModelConfig, qpos: torch.Tensor,
                kpos: torch.Tensor) -> torch.Tensor:
    """(B, qc, kc) bool mask for one chunk pair (causal [+ window])."""
    m = qpos[:, :, None] >= kpos[:, None, :]
    if cfg.sliding_window > 0:
        m = m & ((qpos[:, :, None] - kpos[:, None, :]) < cfg.sliding_window)
    return m


def _flash_fwd(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, q_positions: torch.Tensor,
               kv_positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B,S,Hq,hd), lse (B,Hkv,G,S) log-sum-exp per query).

    Query chunks outer, KV chunks inner, as the reference's two scans; the
    running max, sum and accumulator are f32, probabilities are cast to the
    value dtype before the PV product, and causally fully masked KV chunks
    are still computed.
    """
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qc = _pick_chunk(s, cfg.attn_q_chunk)
    kc = _pick_chunk(s, cfg.attn_kv_chunk)
    scale = hd ** -0.5
    f32 = torch.float32

    # (B, Hkv, G, S, hd) view of q; K/V as (B, Hkv, S, hd).
    qg = q.reshape(b, s, hkv, g, hd).permute(0, 2, 3, 1, 4)
    kt = k.permute(0, 2, 1, 3)
    vt = v.permute(0, 2, 1, 3)
    outs, lses = [], []
    n_q, n_k = s // qc, s // kc
    for iq in steps(n_q):
        q0 = iq * qc
        # (B, Hkv, G*qc, hd): each KV head's G query heads in one product.
        q_blk = qg[:, :, :, q0:q0 + qc].to(f32).reshape(b, hkv, g * qc, hd)
        qpos = q_positions[:, q0:q0 + qc]
        m = torch.full((b, hkv, g, qc), NEG_INF, dtype=f32, device=q.device)
        l = torch.zeros((b, hkv, g, qc), dtype=f32, device=q.device)
        acc = torch.zeros((b, hkv, g, qc, hd), dtype=f32, device=q.device)
        for ik in steps(n_k):
            k0 = ik * kc
            k_blk = kt[:, :, k0:k0 + kc].to(f32)               # (B,Hkv,kc,hd)
            v_blk = vt[:, :, k0:k0 + kc]
            sco = torch.matmul(q_blk, k_blk.transpose(-1, -2)) \
                .reshape(b, hkv, g, qc, -1) * scale            # (B,Hkv,G,qc,kc)
            sco = _softcap(sco, cfg.attn_logit_softcap)
            mask = _mask_block(cfg, qpos, kv_positions[:, k0:k0 + kc])
            sco = torch.where(mask[:, None, None], sco, NEG_INF)
            m_new = torch.maximum(m, sco.amax(dim=-1))
            p = torch.exp(sco - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.matmul(p.to(v_blk.dtype).to(f32).reshape(b, hkv, -1, kc),
                              v_blk.to(f32))
            acc = acc * corr[..., None] + pv.reshape(b, hkv, g, qc, hd)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.to(q.dtype))
        lses.append(m + torch.log(torch.clamp(l, min=1e-30)))
    out = torch.cat(pad(outs, n_q), dim=3)                     # (B,Hkv,G,S,hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, hd)
    return out, torch.cat(pad(lses, n_q), dim=3)


def _flash_vjp_fn(cfg: ModelConfig):
    """Custom-VJP flash attention for ``cfg``: a function of (q, k, v,
    qpos, kpos) that returns (out, lse), with O(qc * kc) backward
    temporaries (``_FlashVJP``).  Raises under a logit softcap, whose
    derivative the backward does not implement, as the reference does.
    """
    if cfg.attn_logit_softcap > 0:
        raise NotImplementedError(
            "flash_vjp does not implement the softcap derivative")
    return functools.partial(_FlashVJP.apply, cfg)


class _FlashVJP(torch.autograd.Function):
    """The forward is ``_flash_fwd`` and saves (q, k, v, positions, out,
    lse).  The backward walks KV chunks outer and q chunks inner, as the
    reference's two scans: P recomputed from ``lse``, ``delta = sum(do *
    out)`` per query, dk and dv accumulated in f32 over the q chunks and
    dq in f32 over the KV chunks.  Chunk intermediates (do, P, dS) are
    rounded to the model dtype and multiplied in f32, as the reference's
    einsums with ``preferred_element_type=f32``.  No grad flows into lse.
    """

    @staticmethod
    def forward(ctx, cfg, q, k, v, qpos, kpos):
        out, lse = _flash_fwd(cfg, q, k, v, qpos, kpos)
        ctx.cfg = cfg
        ctx.save_for_backward(q, k, v, qpos, kpos, out, lse)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, qpos, kpos, out, lse = ctx.saved_tensors
        return (None, *_flash_bwd(ctx.cfg, q, k, v, qpos, kpos, out, lse, do),
                None, None)


def _flash_bwd(cfg: ModelConfig, q, k, v, qpos, kpos, out, lse, do):
    """(dq, dk, dv) of ``_flash_fwd``'s out (see ``_FlashVJP``)."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qc = _pick_chunk(s, cfg.attn_q_chunk)
    kc = _pick_chunk(s, cfg.attn_kv_chunk)
    scale = hd ** -0.5
    f32 = torch.float32
    wdt = q.dtype

    def grouped(x):                      # (B,S,Hq,hd) -> (B,Hkv,G,S,hd)
        return x.reshape(b, s, hkv, g, hd).permute(0, 2, 3, 1, 4)

    qg = grouped(q)
    dog = grouped(do.to(wdt))
    # delta_i = sum_d do * out per query (rescales dp -> ds)
    delta = torch.sum(do.to(f32) * out.to(f32), dim=-1)       # (B,S,Hq)
    delta = delta.reshape(b, s, hkv, g).permute(0, 2, 3, 1)   # (B,Hkv,G,S)
    kt = k.permute(0, 2, 1, 3)                                # (B,Hkv,S,hd)
    vt = v.permute(0, 2, 1, 3)
    n_q, n_k = s // qc, s // kc
    dq = [torch.zeros((b, hkv, g, qc, hd), dtype=f32, device=q.device)
          for _ in range(n_q)]
    dks, dvs = [], []
    for ik in steps(n_k):
        k0 = ik * kc
        k_blk = kt[:, :, k0:k0 + kc].to(f32)                 # (B,Hkv,kc,hd)
        v_blk = vt[:, :, k0:k0 + kc].to(f32)
        kpb = kpos[:, k0:k0 + kc]
        dk_blk = torch.zeros((b, hkv, kc, hd), dtype=f32, device=q.device)
        dv_blk = torch.zeros_like(dk_blk)
        for i in steps(n_q):
            q0 = i * qc
            q_blk = qg[:, :, :, q0:q0 + qc].to(f32).reshape(b, hkv, g * qc, hd)
            do_blk = dog[:, :, :, q0:q0 + qc].to(f32).reshape(b, hkv, g * qc, hd)
            sco = torch.matmul(q_blk, k_blk.transpose(-1, -2)) \
                .reshape(b, hkv, g, qc, kc) * scale
            mask = _mask_block(cfg, qpos[:, q0:q0 + qc], kpb)[:, None, None]
            p = torch.where(mask, torch.exp(sco - lse[..., q0:q0 + qc, None]),
                            torch.zeros_like(sco))
            p_w = p.to(wdt).to(f32).reshape(b, hkv, g * qc, kc)
            dv_blk = dv_blk + torch.matmul(p_w.transpose(-1, -2), do_blk)
            dp = torch.matmul(do_blk, v_blk.transpose(-1, -2)) \
                .reshape(b, hkv, g, qc, kc)
            ds = (p * (dp - delta[..., q0:q0 + qc, None]) * scale) \
                .to(wdt).to(f32).reshape(b, hkv, g * qc, kc)
            dq[i] = dq[i] + torch.matmul(ds, k_blk).reshape(b, hkv, g, qc, hd)
            dk_blk = dk_blk + torch.matmul(ds.transpose(-1, -2), q_blk)
        dks.append(dk_blk)
        dvs.append(dv_blk)
    dq = torch.cat(dq, dim=3).permute(0, 3, 1, 2, 4).reshape(b, s, hq, hd)
    dk = torch.cat(pad(dks, n_k), dim=2).permute(0, 2, 1, 3)
    dv = torch.cat(pad(dvs, n_k), dim=2).permute(0, 2, 1, 3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_forward(cfg: ModelConfig, params: dict, x: torch.Tensor,
                      positions: torch.Tensor, compute_dtype,
                      par=None) -> torch.Tensor:
    """Forward-pass self-attention (no cache)."""
    h = Heads(cfg, par)
    q, k, v = _project_qkv(cfg, params, x, positions, compute_dtype, h)
    out = flash_attention(cfg, q, *_attended(h, k, v), positions, positions)
    b, s = x.shape[:2]
    return _out_proj(h, cfg, params, out.reshape(b, s, -1), compute_dtype)


def attention_prefill(cfg: ModelConfig, params: dict, x: torch.Tensor,
                      positions: torch.Tensor, cache: dict,
                      compute_dtype, par=None) -> tuple[torch.Tensor, dict]:
    """Prefill: causal attention, and K/V written into the cache at [0, S)."""
    h = Heads(cfg, par)
    q, k, v = _project_qkv(cfg, params, x, positions, compute_dtype, h)
    out = flash_attention(cfg, q, *_attended(h, k, v), positions, positions)
    s = x.shape[1]
    s0, n = 0, s
    if par is not None and par.cp:      # the rows of [0, S) in this block
        s_loc = cache["k"].shape[1]
        s0 = par.data_rank() * s_loc
        n = min(max(s - s0, 0), s_loc)
    # In place; the reference's dynamic_update_slice is functional.
    cache["k"][:, :n] = k[:, s0:s0 + n].to(cache["k"].dtype)
    cache["v"][:, :n] = v[:, s0:s0 + n].to(cache["v"].dtype)
    b = x.shape[0]
    y = _out_proj(h, cfg, params, out.reshape(b, s, -1), compute_dtype)
    return y, cache


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device) -> dict:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_decode(cfg: ModelConfig, params: dict, x: torch.Tensor,
                     pos: torch.Tensor, cache: dict,
                     compute_dtype, par=None) -> tuple[torch.Tensor, dict]:
    """One-token decode: x (B, 1, d), pos (B,) int32 current position.

    Writes k/v at ``pos`` and attends over cache[0..pos].  Under ``par``
    x, pos and the cache are the rank's rows (module docstring); under
    context parallelism its block of the sequence.
    """
    b = x.shape[0]
    h = Heads(cfg, par)
    q, k, v = _project_qkv(cfg, params, x, pos[:, None], compute_dtype, h)

    # In place; the reference's .at[batch, pos].set is functional and its
    # caller donates the old cache.
    rows = torch.arange(b, device=x.device)
    ck, cv = cache["k"], cache["v"]
    cp = par is not None and par.cp
    if cp:
        # Rows [s0, s0 + S_loc): only the rank that owns pos writes (the
        # others write their row back as it is, with no sync on pos).
        s0 = par.data_rank() * ck.shape[1]
        at = (pos.long() - s0).clamp(0, ck.shape[1] - 1)
        own = ((pos.long() - s0) == at)[:, None, None]
        ck[rows, at] = torch.where(own, k[:, 0].to(ck.dtype), ck[rows, at])
        cv[rows, at] = torch.where(own, v[:, 0].to(cv.dtype), cv[rows, at])
    else:
        ck[rows, pos.long()] = k[:, 0].to(ck.dtype)
        cv[rows, pos.long()] = v[:, 0].to(cv.dtype)

    s_max = ck.shape[1]
    # The KV heads the rank's q heads read (all of them without a split).
    ck, cv = ck.narrow(2, h.kv0, h.n_kv), cv.narrow(2, h.kv0, h.n_kv)
    hkv, hd = h.n_kv, cfg.head_dim
    g = h.hq // hkv
    qg = q.reshape(b, hkv, g, hd)
    kernel = (cfg.use_pallas_decode or x.device.type != "cpu") \
        and cfg.sliding_window == 0 and cfg.attn_logit_softcap == 0
    if cp:
        if kernel:
            part = ops.decode_attention_partial(
                qg.to(compute_dtype).contiguous(),
                ck.transpose(1, 2).to(compute_dtype),
                cv.transpose(1, 2).to(compute_dtype),
                (pos - s0).clamp(-1, s_max - 1).to(torch.int32))
        else:
            part = _partial_einsum(cfg, qg, ck, cv, pos, s0, compute_dtype)
        out = _combine(*part, par.data_group())
    elif kernel:
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
    y = _out_proj(h, cfg, params, out.reshape(b, 1, -1).to(compute_dtype),
                  compute_dtype)
    return y, cache


def _partial_einsum(cfg: ModelConfig, qg, ck, cv, pos, s0: int, cdt):
    """The einsum path's softmax partial over the rank's block of the
    cache (rows s0 + [0, S_loc), masked by the global positions, with
    the softcap and window): (out (B, Hkv, G, hd), lse (B, Hkv, G)), f32;
    an empty window gives out = 0 and lse = -inf.  Probabilities are cast
    to the compute dtype before the PV product, as the whole cache's."""
    hd = cfg.head_dim
    sco = torch.einsum("bngd,bsnd->bngs", qg.float(), ck.to(cdt).float()) \
        * hd ** -0.5
    sco = _softcap(sco, cfg.attn_logit_softcap)
    kv_pos = s0 + torch.arange(ck.shape[1], device=qg.device)[None, :]
    mask = kv_pos <= pos[:, None]
    if cfg.sliding_window > 0:
        mask = mask & ((pos[:, None] - kv_pos) < cfg.sliding_window)
    sco = torch.where(mask[:, None, None, :], sco,
                      torch.full_like(sco, float("-inf")))
    lse = torch.logsumexp(sco, dim=-1)
    p = torch.exp(sco - torch.where(torch.isfinite(lse), lse,
                                    torch.zeros_like(lse))[..., None])
    out = torch.einsum("bngs,bsnd->bngd", p.to(cdt).float(),
                       cv.to(cdt).float())
    return out, lse


def _combine(out: torch.Tensor, lse: torch.Tensor, group) -> torch.Tensor:
    """The attention output over the whole sequence from the ranks'
    partials (f32): M = max of the lse over ``group``, w = exp(lse - M),
    sum(w out) / sum(w) in one all-reduce.  A rank with an empty window
    (lse = -inf) weighs 0; the rank holding row 0 sees a row whenever
    pos >= 0, so M is finite."""
    w = torch.exp(lse - all_max(lse, group))[..., None]
    both = all_reduce(torch.cat([out * w, w], dim=-1), group)
    return both[..., :-1] / both[..., -1:]
