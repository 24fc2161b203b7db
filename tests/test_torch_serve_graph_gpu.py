"""The serve step replayed from a CUDA graph against the eager step, on a
card (``repro_torch.launch.step_graph``).

Imports no JAX, so it runs where the kernels do:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_serve_graph_gpu.py -s

Granite- and deepseek-shaped models (published widths, heads, experts
and top-k; two MoE layers, deepseek's dense first layer besides), batch
8, prompt 64, 6 steps, under a profiler so the program's counters
record.  The graph replays the eager step's kernels in its order on the
same operands, so tokens, logits and caches must agree bit for bit.
Without a CUDA card every test here skips.
"""
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import Parallel, decode_step, init_params, prefill
from repro_torch.models.model import gather_logits
from repro_torch.obs import spans
from repro_torch.tree import tree_leaves

pytestmark = pytest.mark.gpu

BATCH, PLEN, STEPS = 8, 64, 6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(cfg, dev, seed=0):
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dev)
    toks = torch.randint(0, cfg.vocab_size, (BATCH, PLEN), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1),
                         dtype=torch.int32)
    with torch.no_grad():
        logits, cache = prefill(cfg, params, {"tokens": toks},
                                PLEN + STEPS + 2)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    pos = torch.full((BATCH,), PLEN, dtype=torch.int32, device=dev)
    return params, cache, tok, pos


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def _eager(cfg, params, cache, tok, pos):
    """The serve step as the model computes it, launched kernel by
    kernel."""
    par = Parallel()
    logits, cache = decode_step(cfg, params, cache, tok, pos, par=par)
    logits = gather_logits(cfg, logits, par)
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], logits


def _run(step_fn, params, cache, tok, pos, n=STEPS):
    """``n`` steps from (tok, pos); the tokens and logits of each step and
    the launch counters' difference."""
    before = ops.launch_snapshot()
    outs = []
    with torch.no_grad():
        for _ in range(n):
            tok, logits = step_fn(params, cache, tok, pos)[:2]
            outs.append((tok, logits))
            pos = pos + 1
    torch.cuda.synchronize()
    after = ops.launch_snapshot()
    return outs, {k: after[k] - before[k] for k in after}


def _equal_trees(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-moe-16b"])
def test_replay_equals_eager(card, arch):
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=3 if cfg.first_layer_dense else 2)
    params, cache, tok, pos = _model(cfg, card)
    eager_cache = _clone(cache)
    step = make_serve_step(cfg, Parallel())
    spans.clear()
    with profile(activities=[ProfilerActivity.CUDA]):
        want, want_launches = _run(
            lambda *a: _eager(cfg, *a), params, eager_cache, tok, pos)
        want_counts = spans.counters()
    spans.clear()
    with profile(activities=[ProfilerActivity.CUDA]):
        got, got_launches = _run(step, params, cache, tok, pos)
        counts = spans.counters()
    spans.clear()
    for i, ((t, lg), (wt, wl)) in enumerate(zip(got, want)):
        assert torch.equal(t, wt), f"step {i}: tokens differ"
        assert torch.equal(lg, wl), \
            f"step {i}: logits differ by {(lg.float() - wl.float()).abs().max()}"
    assert _equal_trees(cache, eager_cache)
    assert got_launches == want_launches
    assert want_launches[("gmm", None)] > 0 \
        and want_launches[("decode_attention", None)] == cfg.n_layers * STEPS
    print(f"{arch}: counters {counts}, launches a step "
          f"gmm {want_launches[('gmm', None)] // STEPS}, decode_attention "
          f"{want_launches[('decode_attention', None)] // STEPS}")
    assert counts["serve.graph_replays"] >= STEPS - 2
    assert counts["serve.graph_replays"] + counts.get("serve.graph_eager", 0) \
        == STEPS
    assert counts["serve.graph_captures"] >= 1
    # The MoE's counters read as the eager step's: the replays count the
    # captured plans.
    assert counts["moe.copies_routed"] == STEPS * 2 * BATCH * cfg.top_k
    for name in ("moe.copies_routed", "moe.copies_dropped"):
        assert counts[name] == want_counts[name]
    # A copy of the cache (the benchmark's stale-state fault): a new key,
    # captured anew; the step writes the copy and leaves the original.
    stale = _clone(cache)
    kept = _clone(cache)
    ref = _clone(cache)
    last_tok, last_pos = got[-1][0], pos + STEPS
    with torch.no_grad():
        tok_s, logits_s, out = step(params, stale, last_tok, last_pos)
        tok_r, logits_r = _eager(cfg, params, ref, last_tok, last_pos)
    torch.cuda.synchronize()
    assert out is stale and steps._GRAPHS.graph.key[2] == tuple(
        t.data_ptr() for t in tree_leaves(stale))
    assert _equal_trees(cache, kept) and not _equal_trees(stale, kept)
    assert _equal_trees(stale, ref)
    assert torch.equal(tok_s, tok_r) and torch.equal(logits_s, logits_r)


def test_a_recurrent_state_runs_eager(card):
    cfg = smoke_config("xlstm-350m")
    params, cache, tok, pos = _model(cfg, card)
    eager_cache = _clone(cache)
    want, want_launches = _run(
        lambda *a: _eager(cfg, *a), params, eager_cache, tok, pos, 3)
    spans.clear()
    with profile(activities=[ProfilerActivity.CUDA]):
        got, got_launches = _run(make_serve_step(cfg, Parallel()), params,
                                 cache, tok, pos, 3)
        counts = spans.counters()
    spans.clear()
    print(f"xlstm-350m smoke: counters {counts}")
    assert counts == {"serve.graph_eager": 3}
    for (t, lg), (wt, wl) in zip(got, want):
        assert torch.equal(t, wt) and torch.equal(lg, wl)
    assert _equal_trees(cache, eager_cache)
    assert got_launches == want_launches
