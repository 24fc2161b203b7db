"""Plain PyTorch reference of the benchmark's MoE transformers, written from
the models' published equations and the configuration file alone.

One decoder block: x += attention(rmsnorm(x)); x += ffn(rmsnorm(x)), where
attention is causal multi-head attention with rotary positions (half
rotation, theta from the file) over grouped KV heads, and ffn is a dense
SwiGLU (deepseek's first layer) or a mixture of experts: a softmax router,
the top-k experts of each token (the lower index first among equal
scores), their weights renormalised over the k, a capacity of
ceil(capacity_factor * T * k / E) copies an expert in each routing group
of T tokens, copies beyond it dropped in token order, SwiGLU experts, and
always-active shared experts.  The logits are the final rmsnorm times the
head (the embedding's transpose where tied), over the padded vocabulary.

Everything is f32 with TF32 off (the caller sets the backends), computed
layer by layer: a weight is cast to f32 where it is used, so bf16 weights
never sit whole in f32 on the card.  ``prec="fp8"`` is the control: every
matrix product's operands rounded to float8 e4m3 (a scale per row of the
left operand and per column of the right), so that a comparison can be
shown to fail a precision below the configuration's bf16.

Serving (``serve_logits``) follows a batch as the program serves it: one
prefill of the prompts (one routing group of B * S tokens), then one
decode step per fed token (a routing group of B tokens each), every row
attending over all its earlier positions.  Training (``train_steps``)
runs the loss, its gradients through autograd and AdamW.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .yardstick import Sizes

F32 = torch.float32
E4M3_MAX = 448.0
SCORE_BYTES = 1 << 30          # a block of attention scores, at most


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to e4m3 with one scale per slice along ``dim``."""
    amax = x.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(F32) * scale
    return x + (q - x).detach()          # rounded forward, identity grad


def mm(a: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    a, w = a.to(F32), w.to(F32)
    if prec == "fp8":
        a, w = _fp8(a, -1), _fp8(w, -2)
    return a @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.to(F32)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, L, H, hd) rotated by positions 0..L-1."""
    hd, length = x.shape[-1], x.shape[1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=F32, device=x.device) / hd)
    ang = torch.arange(length, dtype=F32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


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


def swiglu(p: dict, x: torch.Tensor, prec: str) -> torch.Tensor:
    return mm(F.silu(mm(x, p["w_gate"], prec)) * mm(x, p["w_up"], prec),
              p["w_down"], prec)


def moe(s: Sizes, p: dict, h: torch.Tensor, groups, prec: str):
    """h (T, d), routing groups of the given sizes in order -> (y, aux)."""
    logits = mm(h, p["router"], "f32")
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :s.top_k], top_i[:, :s.top_k]
    weight = (top_p / top_p.sum(-1, keepdim=True)).reshape(-1)
    expert = top_i.reshape(-1)                 # copy t * k + j
    kept, start = [], 0
    for n in groups:                           # copies kept in token order
        e = expert[start * s.top_k:(start + n) * s.top_k]
        rank = F.one_hot(e, s.n_experts).cumsum(0).gather(1, e[:, None])[:, 0]
        kept.append(rank <= s.capacity(n))
        start += n
    kept = torch.cat(kept)
    copies = torch.nonzero(kept)[:, 0]
    order = copies[torch.argsort(expert[copies], stable=True)]
    counts = torch.bincount(expert[order], minlength=s.n_experts).tolist()
    y = torch.zeros_like(h)
    for e, chunk in enumerate(torch.split(order, counts)):
        if chunk.numel() == 0:
            continue
        tok = chunk // s.top_k
        w = {k: p[k][e] for k in ("w_gate", "w_up", "w_down")}
        y.index_add_(0, tok, swiglu(w, h[tok], prec) * weight[chunk, None])
    if s.n_shared:
        y = y + swiglu(p["shared"], h, prec)
    hits = torch.bincount(expert, minlength=s.n_experts).to(F32)
    balance = s.n_experts * torch.sum(probs.mean(0) * hits / expert.numel())
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return y, balance + 1e-3 * z


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


def head(s: Sizes, params: dict, x: torch.Tensor, prec: str) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"]["scale"], s.norm_eps)
    w = params["embed"].T if s.tie_embeddings else params["head"]
    return mm(x, w, prec)


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


# --------------------------------------------------------------------- #
# Training
# --------------------------------------------------------------------- #


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


def cosine(warmup: int, total: int, final: float = 0.1):
    def fn(step: int) -> float:
        if step < warmup:
            return step / max(warmup, 1)
        prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return final + (1 - final) * 0.5 * (1 + math.cos(math.pi * prog))
    return fn


def train_steps(s: Sizes, params: dict, batches, opt: dict, schedule,
                prec: str = "f32") -> dict:
    """AdamW steps on ``params`` (f32 leaves, updated in place), one a
    batch of (tokens, labels).  Returns each step's loss, each leaf's
    first clipped gradient (as the first moment holds it: its norm), and
    each leaf's norm of its first unclipped gradient."""
    leaves = [t for _, t in leaf_paths(params)]
    for t in leaves:
        t.requires_grad_(True)
    mu = [torch.zeros_like(t) for t in leaves]
    nu = [torch.zeros_like(t) for t in leaves]
    out = {"loss": [], "grad_norms": None, "raw_grad_norms": None}
    b1, b2 = opt["b1"], opt["b2"]
    for step, (tokens, labels) in enumerate(batches):
        value = loss(s, params, tokens, labels, prec)
        grads = torch.autograd.grad(value, leaves)
        out["loss"].append(float(value.detach()))
        with torch.no_grad():
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            clip = torch.clamp(opt["grad_clip"] / (gnorm + 1e-9), max=1.0)
            c1, c2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
            lr = opt["lr"] * schedule(step)
            for p, g, m, v in zip(leaves, grads, mu, nu):
                g = g * clip
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                p.sub_(lr * ((m / c1) / (torch.sqrt(v / c2) + opt["eps"])
                             + opt["weight_decay"] * p))
            if step == 0:
                out["grad_norms"] = [float(torch.linalg.vector_norm(m)) / (1 - b1)
                                     for m in mu]
                out["raw_grad_norms"] = [float(torch.linalg.vector_norm(g))
                                         for g in grads]
        del grads
    for t in leaves:
        t.requires_grad_(False)
    return out


def leaf_paths(tree, path=()):
    """(path, leaf) in the port's tree order: dict keys sorted, lists in
    order, depth first."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaf_paths(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, node in enumerate(tree)
                for x in leaf_paths(node, path + (i,))]
    return [(path, tree)]
