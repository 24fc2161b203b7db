"""Family ``attn_moe``: decoder blocks of causal multi-head attention over
grouped KV heads in front of a mixture of experts (deepseek-moe-16b,
granite-moe-3b-a800m).

One decoder block: x += attention(rmsnorm(x)); x += ffn(rmsnorm(x)), where
attention is causal multi-head attention with rotary positions (half
rotation, theta from the file) over grouped KV heads, and ffn is a dense
SwiGLU (deepseek's first layer) or a mixture of experts
(``reference.moe``).  The logits are the final rmsnorm times the head (the
embedding's transpose where tied), over the padded vocabulary.

Serving (``serve_logits``) follows a batch as the program serves it: one
prefill of the prompts (one routing group of B * S tokens), then one
decode step per fed token (a routing group of B tokens each), every row
attending over all its earlier positions.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils.checkpoint import checkpoint

from h100bench.families import sizes_from
from h100bench.reference import (F32, SCORE_BYTES, _fp8, head, mm, moe,
                                 rmsnorm, rope, swiglu)
from h100bench.yardstick import BF16_BYTES

NAME = "attn_moe"


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The model's sizes as the configuration file states them."""

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    vocab_size: int
    padded_vocab: int
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int
    first_dense_d_ff: int          # 0: no dense first layer
    tie_embeddings: bool
    rope_theta: float
    norm_eps: float
    capacity_factor: float

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def n_moe_layers(self) -> int:
        return self.n_layers - (1 if self.first_dense_d_ff else 0)

    def capacity(self, n_tokens: int) -> int:
        """Slots per expert for a routing group of ``n_tokens`` tokens."""
        c = math.ceil(self.capacity_factor * n_tokens * self.top_k
                      / self.n_experts)
        return max(c, self.top_k)


def sizes_of(model: dict) -> Sizes:
    """``Sizes`` from a configuration file's ``model`` group."""
    return sizes_from(Sizes, model, NAME)


SMOKE = dict(n_layers=2, d_model=64, n_heads=4, head_dim=16, vocab_size=500,
             padded_vocab=512, d_expert=32, first_dense_d_ff=64)


def smoke(s: Sizes) -> Sizes:
    """The same structure at a size the CPU runs in seconds."""
    kv = max(1, round(4 * s.n_kv_heads / s.n_heads))
    return dataclasses.replace(
        s, **{**SMOKE, "n_layers": 2 + (1 if s.first_dense_d_ff else 0),
              "first_dense_d_ff": SMOKE["first_dense_d_ff"] if s.first_dense_d_ff else 0},
        n_kv_heads=kv, n_experts=min(s.n_experts, 8), top_k=min(s.top_k, 4),
        n_shared=min(s.n_shared, 1))


# --------------------------------------------------------------------- #
# Weights
# --------------------------------------------------------------------- #


def leaf_specs(s: Sizes):
    """(path, shape, std, kind) of every weight, in draw order; ``kind`` is
    "norm" for a norm scale (drawn around 1), "router" for the f32
    router, "w" for the rest."""
    d = s.d_model
    std = d ** -0.5                    # 0.022 (deepseek), 0.026 (granite)
    out_std = std / math.sqrt(2 * s.n_layers)
    specs = [(("embed",), (s.padded_vocab, d), std, "w"),
             (("final_norm", "scale"), (d,), 0.1, "norm")]
    if not s.tie_embeddings:
        specs.append((("head",), (d, s.padded_vocab), std, "w"))

    def block(prefix, ffn):
        specs.extend([
            (prefix + ("norm1", "scale"), (d,), 0.1, "norm"),
            (prefix + ("mixer", "w_q"), (d, s.q_dim), std, "w"),
            (prefix + ("mixer", "w_k"), (d, s.kv_dim), std, "w"),
            (prefix + ("mixer", "w_v"), (d, s.kv_dim), std, "w"),
            (prefix + ("mixer", "w_o"), (s.q_dim, d), out_std, "w"),
            (prefix + ("norm2", "scale"), (d,), 0.1, "norm")])
        specs.extend((prefix + ("ffn",) + p, shape, std, kind)
                     for p, shape, std, kind in ffn)

    def swiglu(prefix, width):
        return [(prefix + ("w_gate",), (d, width), std, "w"),
                (prefix + ("w_up",), (d, width), std, "w"),
                (prefix + ("w_down",), (width, d), out_std, "w")]

    if s.first_dense_d_ff:
        block(("first",), swiglu((), s.first_dense_d_ff))
    e, f = s.n_experts, s.d_expert
    moe = [(("router",), (d, e), std, "router"),
           (("w_gate",), (e, d, f), std, "w"),
           (("w_up",), (e, d, f), std, "w"),
           (("w_down",), (e, f, d), out_std, "w")]
    if s.n_shared:
        moe += swiglu(("shared",), f * s.n_shared)
    for i in range(s.n_moe_layers):
        block(("layers", i), moe)
    return specs


# --------------------------------------------------------------------- #
# The port's configuration
# --------------------------------------------------------------------- #


def want(s: Sizes) -> dict:
    """The port's ``ModelConfig`` attributes the sizes fix, and their
    values (a dense first layer of ``first_dense_d_ff``, or none)."""
    out = dict(n_layers=s.n_layers, d_model=s.d_model, n_heads=s.n_heads,
               n_kv_heads=s.n_kv_heads, head_dim=s.head_dim,
               vocab_size=s.vocab_size, padded_vocab=s.padded_vocab,
               n_experts=s.n_experts, top_k=s.top_k, d_ff_expert=s.d_expert,
               n_shared_experts=s.n_shared,
               first_layer_dense=bool(s.first_dense_d_ff),
               tie_embeddings=s.tie_embeddings, rope_theta=s.rope_theta,
               norm_eps=s.norm_eps, capacity_factor=s.capacity_factor)
    if s.first_dense_d_ff:
        out["first_dense_d_ff"] = s.first_dense_d_ff
    return out


def smoke_config(s: Sizes) -> dict:
    """The ``ModelConfig`` fields set for the smoke-size model ``s``: what
    ``want`` fixes (``padded_vocab`` through ``vocab_pad_multiple``; the
    registered config keeps ``first_layer_dense``), at ``s``'s sizes."""
    fixed = {k: v for k, v in want(s).items()
             if k not in ("padded_vocab", "first_layer_dense")}
    return dict(fixed, first_dense_d_ff=s.first_dense_d_ff, d_ff=s.d_expert,
                vocab_pad_multiple=s.padded_vocab, attn_q_chunk=16,
                attn_kv_chunk=16)


# --------------------------------------------------------------------- #
# The reference
# --------------------------------------------------------------------- #


def attention(s: Sizes, p: dict, h: torch.Tensor, prec: str) -> torch.Tensor:
    """Causal attention over the whole sequence of each row."""
    b, length, _ = h.shape
    hd, hkv = s.head_dim, s.n_kv_heads
    g = s.n_heads // hkv
    q = rope(mm(h, p["w_q"], prec).view(b, length, s.n_heads, hd),
             s.rope_theta).view(b, length, hkv, g, hd)
    k = rope(mm(h, p["w_k"], prec).view(b, length, hkv, hd), s.rope_theta)
    v = mm(h, p["w_v"], prec).view(b, length, hkv, hd)
    if prec == "fp8":
        q, k, v = _fp8(q, -1), _fp8(k, -1), _fp8(v, -1)
    rows = max(1, SCORE_BYTES // (4 * b * s.n_heads * length))
    outs = []
    for q0 in range(0, length, rows):
        q1 = min(length, q0 + rows)
        sco = torch.einsum("bqngd,bknd->bngqk", q[:, q0:q1], k[:, :q1]) \
            * hd ** -0.5
        keep = (torch.arange(q1, device=h.device)[None, :]
                <= torch.arange(q0, q1, device=h.device)[:, None])
        sco = sco.masked_fill(~keep, float("-inf"))
        prob = torch.softmax(sco, dim=-1)
        if prec == "fp8":
            prob = _fp8(prob, -1)
        outs.append(torch.einsum("bngqk,bknd->bqngd", prob, v[:, :q1]))
    out = torch.cat(outs, dim=1).reshape(b, length, s.q_dim)
    return mm(out, p["w_o"], prec)


def block(s: Sizes, bp: dict, x: torch.Tensor, groups, flat, unflat,
          prec: str):
    """One decoder block on x (B, L, d); ``flat``/``unflat`` map the rows
    to the routing groups' token order and back.  Returns (x, aux)."""
    x = x + attention(s, bp["mixer"], rmsnorm(x, bp["norm1"]["scale"],
                                             s.norm_eps), prec)
    h = rmsnorm(x, bp["norm2"]["scale"], s.norm_eps)
    if "router" not in bp["ffn"]:
        return x + swiglu(bp["ffn"], h, prec), torch.zeros((), device=x.device)
    y, aux = moe(s, bp["ffn"], flat(h), groups, prec)
    return x + unflat(y), aux


def blocks(params: dict):
    first = [params["first"]] if "first" in params else []
    return first + list(params["layers"])


@torch.no_grad()
def serve_logits(s: Sizes, params: dict, prompts: torch.Tensor,
                 fed: torch.Tensor, prec: str = "f32") -> torch.Tensor:
    """Logits (B, n + 1, V_padded) after the prompt (B, S) and after each
    of the n fed tokens (B, n): the positions the program's prefill and
    decode steps give logits for."""
    b, plen = prompts.shape
    n = fed.shape[1]
    tokens = torch.cat([prompts, fed], dim=1).long()
    x = params["embed"][tokens].to(F32)
    d = s.d_model
    groups = [b * plen] + [b] * n

    def flat(h):            # prompt rows b-major, then each step's rows
        return torch.cat([h[:, :plen].reshape(-1, d),
                          h[:, plen:].transpose(0, 1).reshape(-1, d)])

    def unflat(y):
        return torch.cat([y[:b * plen].view(b, plen, d),
                          y[b * plen:].view(n, b, d).transpose(0, 1)], dim=1)

    for bp in blocks(params):
        x, _ = block(s, bp, x, groups, flat, unflat, prec)
    return head(s, params, x[:, plen - 1:], prec)


def loss(s: Sizes, params: dict, tokens: torch.Tensor, labels: torch.Tensor,
         prec: str = "f32", aux_weight: float = 0.01) -> torch.Tensor:
    """Mean next-token cross-entropy over the labels >= 0, plus
    ``aux_weight`` times the MoE layers' summed load-balance and z losses;
    each block is recomputed in the backward (``checkpoint``)."""
    b, length = tokens.shape
    x = params["embed"][tokens.long()].to(F32)
    groups = [b * length]
    aux = torch.zeros((), device=x.device)

    def run(bp, x):
        return block(s, bp, x, groups, lambda h: h.reshape(-1, s.d_model),
                     lambda y: y.view(b, length, -1), prec)

    for bp in blocks(params):
        x, a = checkpoint(run, bp, x, use_reentrant=False)
        aux = aux + a
    logits = head(s, params, x, prec)
    valid = labels >= 0
    nll = torch.logsumexp(logits, -1) - logits.gather(
        -1, labels.clamp(min=0).long()[..., None])[..., 0]
    ce = (nll * valid).sum() / valid.sum().clamp(min=1)
    return ce + aux_weight * aux


# --------------------------------------------------------------------- #
# Work counts
# --------------------------------------------------------------------- #


def token_matmul_params(s: Sizes) -> float:
    """Multiply-adds a token needs outside attention's score products and
    the output head."""
    attn = s.d_model * (s.q_dim + 2 * s.kv_dim) + s.q_dim * s.d_model
    expert = 3 * s.d_model * s.d_expert
    moe = s.d_model * s.n_experts + (s.top_k + s.n_shared) * expert
    dense = 3 * s.d_model * s.first_dense_d_ff
    return s.n_layers * attn + s.n_moe_layers * moe + dense


def pair_flops(s: Sizes) -> float:
    """Flops of one visible (query, key) pair over all layers: its score
    and its share of the output, 2 * 2 * hd * Hq a layer."""
    return 4.0 * s.q_dim * s.n_layers


def head_flops(s: Sizes, n_logits: float) -> float:
    return 2.0 * s.d_model * s.vocab_size * n_logits


def gmm_need(s: Sizes, n_tokens: int, backward: bool = False) -> tuple[float, float]:
    """(flops, bytes) the routed experts of every MoE layer need for
    ``n_tokens`` tokens: T * top_k copies through gate, up and down; with
    ``backward`` also each product's dx and dw.  Bytes: each product's
    input rows, its expert weights and its output rows, in bf16."""
    copies = n_tokens * s.top_k
    d, f, e = s.d_model, s.d_expert, s.n_experts
    flops = 3 * 2.0 * copies * d * f
    weights = 3 * e * d * f
    rows = copies * (2 * (d + f) + (f + d))   # gate, up: d in, f out; down
    nbytes = BF16_BYTES * (weights + rows)
    if backward:
        # dx reads dy and w, writes dx; dw reads x and dy, writes dw.
        flops *= 3
        nbytes += 2 * BF16_BYTES * (weights + rows)
    return flops * s.n_moe_layers, nbytes * s.n_moe_layers


def decode_attn_row_bytes(s: Sizes, pos: int) -> int:
    """Bytes decode attention needs for one row at ``pos`` in every layer:
    its K and V rows [0, pos] read once, q read and the output written
    once (bf16)."""
    per_row_kv = 2 * s.kv_dim * BF16_BYTES
    per_row_q = 2 * s.q_dim * BF16_BYTES
    return ((pos + 1) * per_row_kv + per_row_q) * s.n_layers
