"""The serve step's CUDA graph (``repro_torch.launch.step_graph``) on the
CPU, where it never engages: the key it replays under, the serve step's
outputs bit for bit against the model's own step, the MoE counters while
a capture runs, and the launch counters a replay adds.

Replay against eager on the card: ``tests/test_torch_serve_graph_gpu.py``.
"""
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import smoke_config
from repro_torch.kernels import decode_attn, moe_gmm, ops
from repro_torch.launch import step_graph, steps
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import Parallel, decode_step, init_params, moe, prefill
from repro_torch.models.model import gather_logits
from repro_torch.obs import spans
from repro_torch.tree import tree_leaves

ARCHS = ["granite-moe-3b-a800m", "deepseek-moe-16b"]


def _model(arch, batch=2, plen=16, steps_=3):
    cfg = smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(5), "cpu",
                         cast=False)
    toks = torch.randint(0, cfg.vocab_size, (batch, plen),
                         generator=torch.Generator().manual_seed(7),
                         dtype=torch.int32)
    with torch.no_grad():
        logits, cache = prefill(cfg, params, {"tokens": toks},
                                plen + steps_ + 1)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    pos = torch.full((batch,), plen, dtype=torch.int32)
    return cfg, params, cache, tok, pos


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def _key(cfg, params, cache, tok, pos):
    return step_graph.step_key(cfg, params, cache, (tok, pos, None))


def test_the_key_follows_every_leaf_and_not_its_values():
    cfg, params, cache, tok, pos = _model(ARCHS[0])
    shapes, key, cuda = _key(cfg, params, cache, tok, pos)
    assert not cuda
    # In-place writes, and new inputs of the same shapes, keep the key.
    cache["layers"][0]["k"].add_(1.0)
    params["layers"][0]["norm1"]["scale"].mul_(2.0)
    assert _key(cfg, params, cache, tok + 1, pos + 1)[1] == key
    # A cache leaf replaced by a copy (the stale-state fault's shape) or
    # by a new tensor of its shape moves the key, not the shapes.
    for leaf in (cache["layers"][1]["v"].clone(),
                 torch.empty_like(cache["layers"][1]["v"])):
        other = {**cache, "layers": [dict(c) for c in cache["layers"]]}
        other["layers"][1]["v"] = leaf
        got = _key(cfg, params, other, tok, pos)
        assert got[1] != key and got[0] == shapes
    # So does a param leaf replaced, or a whole cache cloned.
    swapped = {**params, "final_norm": {"scale":
                                        params["final_norm"]["scale"].clone()}}
    assert _key(cfg, swapped, cache, tok, pos)[1] != key
    assert _key(cfg, params, _clone(cache), tok, pos)[1] != key
    # Another batch, dtype or config is another shape.
    assert _key(cfg, params, cache, tok[:1], pos[:1])[0] != shapes
    assert _key(cfg, params, cache, tok.long(), pos)[0] != shapes
    other_cfg = dataclasses.replace(cfg, norm_eps=cfg.norm_eps * 2)
    assert _key(other_cfg, params, cache, tok, pos)[0] != shapes


def _today(cfg, params, cache, tok, pos):
    """The serve step as the model computes it, with no graph."""
    par = Parallel()
    logits, cache = decode_step(cfg, params, cache, tok, pos, par=par)
    logits = gather_logits(cfg, logits, par)
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], logits


@pytest.mark.parametrize("arch", ARCHS)
def test_on_the_cpu_the_step_runs_eager_and_bit_for_bit(arch):
    cfg, params, cache, tok, pos = _model(arch)
    ref_cache, ref_tok, ref_pos = _clone(cache), tok.clone(), pos.clone()
    step = make_serve_step(cfg, Parallel())
    spans.clear()
    outs = []
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            tok, logits, out = step(params, cache, tok, pos)
            assert out is cache
            outs.append((tok, logits))
            pos = pos + 1
    with torch.no_grad():
        for tok, logits in outs:
            ref_tok, ref_logits = _today(cfg, params, ref_cache, ref_tok,
                                         ref_pos)
            assert torch.equal(tok, ref_tok) and torch.equal(logits,
                                                             ref_logits)
            ref_pos = ref_pos + 1
    got = spans.counters()
    units = [s for s in spans.records() if s.name == "decode_step"]
    spans.clear()
    for a, b in zip(tree_leaves(cache),
                    tree_leaves(ref_cache)):
        assert torch.equal(a, b)
    assert steps._GRAPHS.graph is None and steps._GRAPHS.warm == {}
    assert got["serve.graph_eager"] == 3
    assert "serve.graph_replays" not in got \
        and "serve.graph_captures" not in got
    # One unit a call, with the argmax inside it, nested in none.
    assert len(units) == 3 and all(s.parent is None for s in units)


def test_grad_mode_runs_eager_without_a_key(monkeypatch):
    cfg, params, cache, tok, pos = _model(ARCHS[0])
    monkeypatch.setattr(step_graph, "step_key", pytest.fail)
    with torch.enable_grad():
        make_serve_step(cfg, Parallel())(params, cache, tok, pos)
    assert steps._GRAPHS.warm == {}


def test_copies_are_not_counted_while_a_capture_runs():
    cfg = dataclasses.replace(smoke_config("granite-moe-3b-a800m"), top_k=2,
                              moe_slotting=False)
    idx = torch.tensor([[0, 1], [0, 2], [0, 3], [0, 1], [0, 2], [0, 3]])
    xt = torch.randn(idx.shape[0], cfg.d_model)
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        masks = moe.captured_masks = []
        try:
            moe._dispatch(cfg, xt, idx, 4, 3, 1)
        finally:
            moe.captured_masks = None
        assert spans.counters() == {}
        assert len(masks) == 1 and masks[0].shape == (idx.numel(),)
        # A replay counts a copy of the captured mask: expert 0 drops 3.
        moe._count_copies(masks[0].clone())
        assert spans.counters() == {"moe.copies_routed": 12,
                                    "moe.copies_dropped": 3}
    spans.clear()


def test_a_launch_snapshot_difference_adds_back():
    before = ops.launch_snapshot()
    try:
        assert set(before) >= {("gmm", None), ("gmm", "wgmma"),
                               ("gmm", "fma"), ("decode_attention", None),
                               ("decode_attention", "full"),
                               ("decode_attention", "partial")}
        delta = dict.fromkeys(before, 0)
        delta.update({("gmm", None): 3, ("gmm", "wgmma"): 2,
                      ("gmm", "fma"): 1, ("decode_attention", None): 2,
                      ("decode_attention", "full"): 2})
        ops.add_launches(delta)
        ops.add_launches(delta)
        after = ops.launch_snapshot()
        assert {k: after[k] - before[k] for k in before} == \
            {k: 2 * n for k, n in delta.items()}
        assert moe_gmm.path_launches["wgmma"] - before[("gmm", "wgmma")] == 4
    finally:
        ops.add_launches({k: before[k] - n
                          for k, n in ops.launch_snapshot().items()})
    assert ops.launch_snapshot() == before
    assert decode_attn.launches == before[("decode_attention", None)]
