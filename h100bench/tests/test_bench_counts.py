"""The yardstick's counts on hand-worked shapes, the traffic's batches,
and the reductions of a synthetic trace."""
import json
import math

import pytest
import torch

from h100bench import harness, inputs, yardstick


def sizes(name):
    return harness.find_cell(name).sizes


def test_gmm_count_at_deepseek_prefill_256():
    s = sizes("deepseek-moe-16b.prefill-256")
    t = 256 * 256
    assert s.capacity(t) == 7680                     # 1.25 * 65,536 * 6 / 64
    flops, nbytes = yardstick.gmm_need(s, t)
    per_layer = 3 * 2 * t * 6 * 2048 * 1408
    assert flops == 27 * per_layer                   # 27 MoE layers
    rows = t * 6 * (2 * (2048 + 1408) + 1408 + 2048)
    assert nbytes == 27 * 2 * (3 * 64 * 2048 * 1408 + rows)
    assert yardstick.least_time_s(flops, nbytes) == flops / 989e12
    f2, b2 = yardstick.gmm_need(s, t, backward=True)
    assert (f2, b2) == (3 * flops, 3 * nbytes)


def test_capacity_of_a_decode_group():
    s = sizes("granite-moe-3b-a800m.rag-2k")
    assert s.capacity(64) == 16                      # 1.25 * 64 * 8 / 40
    assert s.capacity(1) == 8                        # never below top_k


def test_decode_attention_bytes_at_ragged_positions():
    s = sizes("granite-moe-3b-a800m.rag-2k")         # 8 KV heads of 64, 24 q
    got = yardstick.decode_attn_bytes(s, [0, 5, 2047])
    kv_row = 2 * 8 * 64 * 2
    q_io = 2 * 24 * 64 * 2
    assert got == 32 * ((1 + 6 + 2048) * kv_row + 3 * q_io)


def test_model_flops_on_a_tiny_config():
    s = yardstick.Sizes(n_layers=2, d_model=4, n_heads=2, n_kv_heads=1,
                        head_dim=2, vocab_size=10, padded_vocab=16,
                        n_experts=4, top_k=2, d_expert=3, n_shared=1,
                        first_dense_d_ff=5, tie_embeddings=False,
                        rope_theta=1e4, norm_eps=1e-5, capacity_factor=1.25)
    attn = 4 * (4 + 2 * 2) + 4 * 4                   # q, k, v, o
    moe = 4 * 4 + (2 + 1) * 3 * 4 * 3                # router, 2 + 1 experts
    per_token = 2 * attn + 1 * moe + 3 * 4 * 5       # one dense layer
    assert yardstick.token_matmul_params(s) == per_token
    pairs = 3 * (1 + 2 + 3)                          # 3 prompts of 3
    want = 2 * per_token * 9 + 4 * 4 * 2 * pairs + 2 * 4 * 10 * 3
    assert yardstick.prefill_flops(s, 3, 3) == want
    step = 2 * per_token * 3 + 4 * 4 * 2 * (3 * 4) + 2 * 4 * 10 * 3
    assert yardstick.decode_flops(s, 3, 3) == step
    assert yardstick.train_flops(s, 3, 3) == 3 * (
        2 * per_token * 9 + 4 * 4 * 2 * pairs + 2 * 4 * 10 * 9)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 3 * 2**40 + 1])
def test_batches_repeat_for_a_seed_and_differ_across_seeds(seed):
    a = inputs.tokens(seed, inputs.BATCHES, 3, (4, 16), 500, "cpu")
    b = inputs.tokens(seed, inputs.BATCHES, 3, (4, 16), 500, "cpu")
    c = inputs.tokens(seed + 1, inputs.BATCHES, 3, (4, 16), 500, "cpu")
    d = inputs.tokens(seed, inputs.BATCHES, 4, (4, 16), 500, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, d)
    assert a.dtype == torch.int32 and 0 <= int(a.min()) and int(a.max()) < 500


def test_weights_redraw_leaf_by_leaf():
    s = harness.smoke_sizes(sizes("deepseek-moe-16b.prefill-256"))
    params = inputs.draw_weights(s, 2**33 + 5, "cpu")
    specs = inputs.leaf_specs(s)
    assert len(specs) == sum(1 for _ in _leaves(params))
    for i in (0, 7, len(specs) - 1):
        again = inputs.draw_leaf(specs[i], i, 2**33 + 5, "cpu", train=False)
        assert torch.equal(again, inputs.leaf_at(params, specs[i][0]))
    assert params["layers"][0]["ffn"]["router"].dtype == torch.float32
    assert params["layers"][0]["ffn"]["w_gate"].dtype == torch.bfloat16


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_trace_reductions_on_a_synthetic_trace():
    m = yardstick.MARKER_KERNEL
    events = [(m, 0.0, 0.1),                          # primer
              (m, 1.0, 1.0), ("gmm_wgmma_kernel", 1.5, 2.0),
              ("elementwise", 1.8, 2.5), (m, 3.0, 3.0),
              ("decode_attn_kernel", 3.5, 3.6), ("Memcpy DtoD", 3.7, 3.8),
              (m, 4.0, 4.0)]
    window, starts, segs = yardstick.segments(events, 3)
    assert window == (1.0, 4.0) and starts == [1.0, 3.0]
    assert [len(x) for x in segs] == [2, 2]
    kernels = [e for seg in segs for e in seg]
    busy = yardstick.union_seconds([(a, b) for _, a, b in kernels])
    assert math.isclose(busy, 1.0 + 0.1 + 0.1)
    gaps = yardstick.idle_gaps([(a, b) for _, a, b in kernels], *window)
    assert [round(g, 9) for _, g in gaps] == [0.5, 1.0, 0.1, 0.2]
    assert math.isclose(yardstick.kernel_seconds(kernels, "gmm_"), 0.5)
    traced = {"window": window, "window_s": 3.0, "busy_s": busy,
              "starts": starts,
              "segments": list(zip(["prefill", "decode"], segs))}
    out = harness.breakdown(traced)
    assert out["device_ops"][0][0] == "elementwise"
    assert dict(out["idle_gaps"])["prefill (all gaps)"] == pytest.approx(1.5)
    assert dict(out["idle_gaps"])["decode (longest gap)"] == pytest.approx(0.2)
    assert yardstick.percentile(list(range(1, 101)), 95) == 95
    json.dumps(out)
