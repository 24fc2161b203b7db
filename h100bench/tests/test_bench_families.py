"""The ``attn_moe`` family gives every number the harness took before
families existed: the work counts of the four cells, pinned; the weights'
specs, the smoke sizes and the reference's logits and loss, against the
pre-family versions copied below (``_old_*``), bit for bit."""
import dataclasses
import math
import types

import pytest
import torch
from torch.utils.checkpoint import checkpoint

from h100bench import harness, inputs, yardstick
from h100bench.metrics._common import decode_positions, unit_flops
from h100bench.reference import (F32, SCORE_BYTES, _fp8, head, mm, moe,
                                 rmsnorm, rope, swiglu)

FAM = harness.family("attn_moe")

# unit flops, gmm_need (flops, bytes) of the unit's prompt tokens, decode
# attention bytes of the unit's decode steps
COUNTS = {
    "deepseek-moe-16b.prefill-256": (
        317805031325696, (183687161315328, 250047627264), 0),
    "granite-moe-3b-a800m.rag-2k": (
        242340411211776, (158329674399744, 418356658176), 268758417408),
    "granite-moe-3b-a800m.train-2k": (
        48340351844352, (29686813949952, 95428804608), 0),
    "deepseek-moe-16b.rag-2k": (
        336845476986880, (183687161315328, 250047627264), 469872148480),
}
CONFIGS = {"deepseek-moe-16b": "deepseek-moe-16b.prefill-256",
           "granite-moe-3b-a800m": "granite-moe-3b-a800m.rag-2k"}


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_counts_are_pinned(name):
    cell = harness.find_cell(name)
    assert cell.family is FAM
    t = cell.traffic
    run = types.SimpleNamespace(cell=cell, sizes=cell.sizes, traffic=t)
    flops, gmm, attn = COUNTS[name]
    assert unit_flops(run) == flops
    tokens = t["batch"] * t.get("prompt_len", t.get("seq_len", 0))
    assert FAM.gmm_need(cell.sizes, tokens,
                        backward=t["kind"] == "train") == gmm
    got = sum(yardstick.decode_attn_bytes(FAM, cell.sizes, [p] * t["batch"])
              for p in decode_positions(run)) if t["kind"] != "train" else 0
    assert got == attn


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_weights_and_smoke_sizes_are_the_old_ones(name):
    s = harness.find_cell(name).sizes
    small = FAM.smoke(s)
    assert dataclasses.asdict(small) == dataclasses.asdict(_old_smoke(s))
    assert FAM.leaf_specs(s) == _old_leaf_specs(s)
    assert FAM.leaf_specs(small) == _old_leaf_specs(small)


@pytest.mark.parametrize("prec", ["f32", "fp8"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_serve_logits_are_the_old_ones_bit_for_bit(config, prec):
    s = FAM.smoke(harness.find_cell(CONFIGS[config]).sizes)
    params = inputs.draw_weights(FAM.leaf_specs(s), 11, "cpu")
    prompts = inputs.tokens(11, inputs.BATCHES, 0, (3, 9), s.vocab_size, "cpu")
    fed = inputs.tokens(11, inputs.BATCHES, 1, (3, 4), s.padded_vocab, "cpu")
    got = FAM.serve_logits(s, params, prompts, fed, prec)
    assert torch.equal(got, _old_serve_logits(s, params, prompts, fed, prec))


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_loss_and_its_gradients_are_the_old_ones_bit_for_bit(config):
    s = FAM.smoke(harness.find_cell(CONFIGS[config]).sizes)
    tokens = inputs.tokens(12, inputs.BATCHES, 0, (2, 17), s.vocab_size, "cpu")
    labels = tokens[:, 1:].clone()
    labels[0, :3] = -1
    out = []
    for fn in (FAM.loss, _old_loss):
        params = inputs.draw_weights(FAM.leaf_specs(s), 12, "cpu", train=True)
        leaves = [t for _, t in _leaves(params)]
        for t in leaves:
            t.requires_grad_(True)
        value = fn(s, params, tokens[:, :-1], labels)
        out.append((value.detach(), torch.autograd.grad(value, leaves)))
    (a, ga), (b, gb) = out
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(ga, gb))


def test_sizes_of_refuses_an_unknown_or_missing_key():
    model = dict(harness.find_cell(CONFIGS["granite-moe-3b-a800m"])
                 .config["model"])
    assert FAM.sizes_of(model) == harness.find_cell(
        CONFIGS["granite-moe-3b-a800m"]).sizes
    with pytest.raises(ValueError, match="kv_lora_rank"):
        FAM.sizes_of({**model, "kv_lora_rank": 512})
    del model["head_dim"]
    with pytest.raises(ValueError, match="head_dim"):
        FAM.sizes_of(model)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield None, tree


# --------------------------------------------------------------------- #
# The pre-family versions, as they were: ``harness.smoke_sizes``,
# ``inputs.leaf_specs`` and ``reference``'s attention, blocks, logits and
# loss.
# --------------------------------------------------------------------- #

_OLD_SMOKE = dict(n_layers=2, d_model=64, n_heads=4, head_dim=16,
                  vocab_size=500, padded_vocab=512, d_expert=32,
                  first_dense_d_ff=64)


def _old_smoke(s):
    kv = max(1, round(4 * s.n_kv_heads / s.n_heads))
    return dataclasses.replace(
        s, **{**_OLD_SMOKE, "n_layers": 2 + (1 if s.first_dense_d_ff else 0),
              "first_dense_d_ff": _OLD_SMOKE["first_dense_d_ff"] if s.first_dense_d_ff else 0},
        n_kv_heads=kv, n_experts=min(s.n_experts, 8), top_k=min(s.top_k, 4),
        n_shared=min(s.n_shared, 1))


def _old_leaf_specs(s):
    d = s.d_model
    std = d ** -0.5
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


def _old_attention(s, p, h, prec):
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


def _old_block(s, bp, x, groups, flat, unflat, prec):
    x = x + _old_attention(s, bp["mixer"], rmsnorm(x, bp["norm1"]["scale"],
                                                   s.norm_eps), prec)
    h = rmsnorm(x, bp["norm2"]["scale"], s.norm_eps)
    if "router" not in bp["ffn"]:
        return x + swiglu(bp["ffn"], h, prec), torch.zeros((), device=x.device)
    y, aux = moe(s, bp["ffn"], flat(h), groups, prec)
    return x + unflat(y), aux


def _old_blocks(params):
    first = [params["first"]] if "first" in params else []
    return first + list(params["layers"])


@torch.no_grad()
def _old_serve_logits(s, params, prompts, fed, prec="f32"):
    b, plen = prompts.shape
    n = fed.shape[1]
    tokens = torch.cat([prompts, fed], dim=1).long()
    x = params["embed"][tokens].to(F32)
    d = s.d_model
    groups = [b * plen] + [b] * n

    def flat(h):
        return torch.cat([h[:, :plen].reshape(-1, d),
                          h[:, plen:].transpose(0, 1).reshape(-1, d)])

    def unflat(y):
        return torch.cat([y[:b * plen].view(b, plen, d),
                          y[b * plen:].view(n, b, d).transpose(0, 1)], dim=1)

    for bp in _old_blocks(params):
        x, _ = _old_block(s, bp, x, groups, flat, unflat, prec)
    return head(s, params, x[:, plen - 1:], prec)


def _old_loss(s, params, tokens, labels, prec="f32", aux_weight=0.01):
    b, length = tokens.shape
    x = params["embed"][tokens.long()].to(F32)
    groups = [b * length]
    aux = torch.zeros((), device=x.device)

    def run(bp, x):
        return _old_block(s, bp, x, groups, lambda h: h.reshape(-1, s.d_model),
                          lambda y: y.view(b, length, -1), prec)

    for bp in _old_blocks(params):
        x, a = checkpoint(run, bp, x, use_reentrant=False)
        aux = aux + a
    logits = head(s, params, x, prec)
    valid = labels >= 0
    nll = torch.logsumexp(logits, -1) - logits.gather(
        -1, labels.clamp(min=0).long()[..., None])[..., 0]
    ce = (nll * valid).sum() / valid.sum().clamp(min=1)
    return ce + aux_weight * aux
