"""Plain PyTorch building blocks of the benchmark's references, written
from the models' published equations and the configuration file alone;
each family (``families/``) builds its blocks, ``serve_logits`` and
``loss`` from them.

The mixture of experts (``moe``): a softmax router, the top-k experts of
each token (the lower index first among equal scores), their weights
renormalised over the k, a capacity of ceil(capacity_factor * T * k / E)
copies an expert in each routing group of T tokens, copies beyond it
dropped in token order, SwiGLU experts, and always-active shared experts.
The logits (``head``) are the final rmsnorm times the head (the
embedding's transpose where tied), over the padded vocabulary.

Everything is f32 with TF32 off (the caller sets the backends), computed
layer by layer: a weight is cast to f32 where it is used, so bf16 weights
never sit whole in f32 on the card.  ``prec="fp8"`` is the control: every
matrix product's operands rounded to float8 e4m3 (a scale per row of the
left operand and per column of the right), so that a comparison can be
shown to fail a precision below the configuration's bf16.

Training (``train_steps``) runs a family's loss, its gradients through
autograd and AdamW.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


def swiglu(p: dict, x: torch.Tensor, prec: str) -> torch.Tensor:
    return mm(F.silu(mm(x, p["w_gate"], prec)) * mm(x, p["w_up"], prec),
              p["w_down"], prec)


def moe(s, p: dict, h: torch.Tensor, groups, prec: str):
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


def head(s, params: dict, x: torch.Tensor, prec: str) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"]["scale"], s.norm_eps)
    w = params["embed"].T if s.tie_embeddings else params["head"]
    return mm(x, w, prec)


# --------------------------------------------------------------------- #
# Training
# --------------------------------------------------------------------- #


def cosine(warmup: int, total: int, final: float = 0.1):
    def fn(step: int) -> float:
        if step < warmup:
            return step / max(warmup, 1)
        prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return final + (1 - final) * 0.5 * (1 + math.cos(math.pi * prog))
    return fn


def train_steps(loss, s, params: dict, batches, opt: dict, schedule,
                prec: str = "f32") -> dict:
    """AdamW steps on ``params`` (f32 leaves, updated in place), one a
    batch of (tokens, labels), on a family's ``loss`` at sizes ``s``.
    Returns each step's loss, each leaf's first clipped gradient (as the
    first moment holds it: its norm), and each leaf's norm of its first
    unclipped gradient."""
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
