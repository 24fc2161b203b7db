"""The model path's spans and counters (``repro_torch.obs.spans``).

On the CPU, under a CPU ``torch.profiler`` (which switches recording on):
spans nest with their parents and units on the main thread and on a
second thread that runs a backward, as autograd's device thread does;
``self_ns`` and ``attribute`` on hand-worked intervals; nothing is
recorded without a profiler; prefill, the serve step and a train step
give the same outputs bit for bit with recording on and off;
``moe.copies_dropped`` against a plain count on hand-made routings; a
train step under unit remat counts each routing once.

The ``gpu``-marked test holds the spans to the device trace's clock
(no JAX here, so it runs on the card):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_spans.py -s
"""
import dataclasses
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import smoke_config
from repro_torch.launch.steps import make_serve_step, make_train_step
from repro_torch.models import Parallel, init_params, prefill
from repro_torch.models import moe
from repro_torch.obs import spans
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.tree import tree_leaves


@pytest.fixture
def recorder():
    """A CPU profiler running around the test, the records cleared."""
    spans.clear()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    yield prof
    if spans.recording():
        prof.stop()
    spans.clear()


def _by_name(recs):
    out = {}
    for s in recs:
        out.setdefault(s.name, []).append(s)
    return out


class _Twice(torch.autograd.Function):
    """x * 2, with a span in its backward."""

    @staticmethod
    def forward(ctx, x):
        return x * 2

    @staticmethod
    def backward(ctx, g):
        with spans.span("grad"):
            return g * 2


def test_spans_nest_by_thread_and_share_their_unit(recorder):
    x = torch.ones(3, requires_grad=True)
    with spans.span("train_step"):
        with spans.span("forward_backward", step=1):
            with spans.span("fwd"):
                loss = _Twice.apply(x).sum()
            # The backward on a thread of its own, as autograd's device
            # thread runs it on a card.
            worker = threading.Thread(target=loss.backward)
            worker.start()
            worker.join(timeout=60)
            assert not worker.is_alive()
        with spans.span("adamw"):
            pass
    with spans.span("decode_step"):
        pass
    recorder.stop()
    got = _by_name(spans.records())
    step, fb = got["train_step"][0], got["forward_backward"][0]
    fwd, grad = got["fwd"][0], got["grad"][0]
    adamw, dec = got["adamw"][0], got["decode_step"][0]
    assert step.parent is None and step.unit == step.id
    assert (fb.parent, fb.unit, fb.attrs) == (step.id, step.id, {"step": 1})
    assert (fwd.parent, fwd.unit) == (fb.id, step.id)
    assert (adamw.parent, adamw.unit) == (step.id, step.id)
    # The other thread's stack was empty: no parent there, the open unit.
    assert (grad.parent, grad.unit) == (None, step.id)
    assert grad.thread != step.thread == fwd.thread
    assert fb.start_ns <= grad.start_ns <= grad.end_ns <= fb.end_ns
    assert (dec.parent, dec.unit) == (None, dec.id) and dec.id != step.id
    for s in (step, fb, fwd, grad, adamw, dec):
        assert s.start_ns <= s.end_ns


def _span(name, a, b, sid, parent=None):
    return spans.Span(name, a, b, sid, parent, 1, 0, {})


def test_self_ns_and_attribute_on_hand_worked_intervals():
    recs = [_span("step", 0, 100, 1), _span("moe", 10, 30, 2, 1),
            _span("attn", 40, 70, 3, 1), _span("gmm", 15, 25, 4, 2),
            _span("gmm", 50, 55, 5, 3)]
    assert spans.self_ns(recs) == {1: 100 - 20 - 30, 2: 20 - 10, 3: 30 - 5,
                                   4: 10, 5: 5}
    # Gaps: [5, 12) -> step 5, moe 2; [20, 45) -> gmm 5, moe 5, step 10,
    # attn 5; [95, 110) -> step 5, outside 10.
    got = spans.attribute(recs, [(5, 12), (20, 45), (95, 110)])
    assert got == {"step": 5 + 10 + 5, "moe": 2 + 5, "gmm": 5, "attn": 5,
                   None: 10}
    assert spans.attribute([], [(0, 7)]) == {None: 7}


def test_nothing_is_recorded_without_a_profiler():
    spans.clear()
    assert not spans.recording()
    assert spans.span("a") is spans.span("b", layer=3)
    with spans.span("a"):
        spans.count("moe.copies_routed", 5)
    assert spans.records() == [] and spans.counters() == {}


def _fresh(arch):
    cfg = smoke_config(arch)
    gen = torch.Generator().manual_seed(5)
    return cfg, init_params(cfg, gen, "cpu", cast=False)


def _serve(arch):
    cfg, params = _fresh(arch)
    gen = torch.Generator().manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen,
                         dtype=torch.int32)
    with torch.no_grad():
        logits, cache = prefill(cfg, params, {"tokens": toks}, 20)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        step = make_serve_step(cfg, Parallel())
        pos = torch.full((2,), 16, dtype=torch.int32)
        outs = [logits]
        for _ in range(2):
            tok, logits, _ = step(params, cache, tok, pos)
            pos = pos + 1
            outs.append(logits)
    return outs


def _train(arch, remat="unit"):
    cfg, params = _fresh(arch)
    cfg = dataclasses.replace(cfg, remat=remat)
    state = adamw_init(params)
    gen = torch.Generator().manual_seed(9)
    toks = torch.randint(0, cfg.vocab_size, (2, 17), generator=gen,
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step = make_train_step(cfg, Parallel(), AdamWConfig(lr=1e-2))
    params, state, metrics = step(params, state, batch)
    return [metrics["loss"], *tree_leaves(params), *tree_leaves(state["mu"])]


SERVE_SPANS = {"prefill", "decode_step", "block", "attn", "moe", "moe.route",
               "moe.dispatch", "moe.experts", "gmm", "moe.combine", "logits"}


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-moe-16b"])
def test_outputs_are_bitwise_equal_with_recording_on_and_off(arch):
    spans.clear()
    off = _serve(arch), _train(arch)
    with profile(activities=[ProfilerActivity.CPU]):
        on = _serve(arch), _train(arch)
    names = {s.name for s in spans.records()}
    spans.clear()
    for a, b in zip(off[0] + off[1], on[0] + on[1]):
        assert torch.equal(a, b)
    want = SERVE_SPANS | {"train_step", "forward_backward", "adamw"}
    if arch == "deepseek-moe-16b":      # shared experts, a dense first block
        want |= {"moe.shared", "ffn"}
    assert want <= names


def test_decode_step_spans_cover_every_block(recorder):
    arch = "deepseek-moe-16b"
    _serve(arch)
    recorder.stop()
    recs = spans.records()
    got = _by_name(recs)
    cfg = smoke_config(arch)
    for unit in got["decode_step"] + got["prefill"]:
        mine = [s for s in recs if s.unit == unit.id]
        blocks = [s.attrs["layer"] for s in mine if s.name == "block"]
        assert blocks == ["first", *range(cfg.n_layers - 1)]
        assert all(unit.start_ns <= s.start_ns <= s.end_ns <= unit.end_ns
                   for s in mine)
    assert len(got["decode_step"]) == 2 and len(got["prefill"]) == 1


def _plain_dropped(idx, n_experts, cap, mine=None):
    flat = idx.reshape(-1)
    keep = torch.ones_like(flat, dtype=torch.bool) if mine is None \
        else mine.reshape(-1)
    seen, dropped = [0] * n_experts, 0
    for e, m in zip(flat.tolist(), keep.tolist()):
        if m:
            seen[e] += 1
            dropped += seen[e] > cap
    return int(keep.sum()), dropped


@pytest.mark.parametrize("case", ["one_overloaded", "none_overloaded",
                                  "random", "this_rank_only"])
def test_copies_dropped_equals_a_plain_count(recorder, case):
    cfg = dataclasses.replace(smoke_config("granite-moe-3b-a800m"), top_k=2,
                              moe_slotting=False)
    n_e, cap, mine = 4, 3, None
    if case == "one_overloaded":        # expert 0: 6 copies for 3 slots
        idx = torch.tensor([[0, 1], [0, 2], [0, 3], [0, 1], [0, 2], [0, 3]])
    elif case == "none_overloaded":
        idx = torch.tensor([[0, 1], [2, 3], [1, 0], [3, 2], [0, 1], [2, 3]])
    else:
        gen = torch.Generator().manual_seed(3)
        idx = torch.stack([torch.randperm(n_e, generator=gen)[:2]
                           for _ in range(11)])
        if case == "this_rank_only":    # buckets 0-1 here, the rest trash
            mine = idx < 2
            idx = torch.where(mine, idx, torch.full_like(idx, 2))
            n_e = 3
    xt = torch.randn(idx.shape[0], cfg.d_model)
    moe._dispatch(cfg, xt, idx, n_e, cap, 1, mine)
    routed, dropped = _plain_dropped(idx, n_e, cap, mine)
    got = spans.counters()
    assert got == {"moe.copies_routed": routed,
                   "moe.copies_dropped": dropped}
    if case == "one_overloaded":
        assert dropped == 3
    if case == "none_overloaded":
        assert dropped == 0


def test_a_remat_train_step_counts_each_routing_once(recorder):
    arch = "granite-moe-3b-a800m"
    cfg = smoke_config(arch)
    _train(arch, remat="unit")
    remat, routes_remat = spans.counters(), len(
        [s for s in spans.records() if s.name == "moe.route"])
    spans.clear()
    _train(arch, remat="none")
    plain, routes_plain = spans.counters(), len(
        [s for s in spans.records() if s.name == "moe.route"])
    recorder.stop()
    n_moe = cfg.n_layers - (1 if cfg.first_layer_dense else 0)
    frag = moe.slotting_for(cfg).frag if cfg.moe_slotting else 1
    assert plain["moe.copies_routed"] == n_moe * 2 * 16 * cfg.top_k * frag
    assert remat == plain
    # The recompute routed again (its spans are there), uncounted.
    assert routes_remat == 2 * routes_plain == 2 * n_moe


@pytest.mark.gpu
def test_a_span_holds_its_kernel_on_the_device_clock():
    """A span around ``torch.cuda._sleep`` and a synchronise contains the
    sleep kernel on the device trace's clock, within 50 us at each end,
    under the benchmark's activity set (CUDA alone)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.autograd import DeviceType
    spans.clear()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    try:
        assert spans.recording()
        primer = torch.zeros(1, device="cuda")
        for _ in range(1000):
            primer.add_(1.0)
        torch.cuda.synchronize()
        for _ in range(3):
            with spans.span("sleep"):
                torch.cuda._sleep(10_000_000)
                torch.cuda.synchronize()
    finally:
        prof.stop()
    assert not spans.recording()
    kernels = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and "spin_kernel" in e.name():
            start = e.start_ns() if hasattr(e, "start_ns") \
                else e.start_us() * 1000
            dur = e.duration_ns() if hasattr(e, "duration_ns") \
                else e.duration_us() * 1000
            kernels.append((start, start + dur))
    held = [s for s in spans.records() if s.name == "sleep"]
    spans.clear()
    assert len(kernels) == len(held) == 3
    for (k0, k1), s in zip(sorted(kernels), sorted(held)):
        print(f"span [{s.start_ns}, {s.end_ns}] kernel [{k0}, {k1}]: "
              f"kernel starts {(k0 - s.start_ns) / 1e3:.1f} us after the "
              f"span, ends {(s.end_ns - k1) / 1e3:.1f} us before its end")
        assert k0 >= s.start_ns - 50_000 and k1 <= s.end_ns + 50_000
        assert k1 - k0 > 1_000_000          # the sleep, not some other launch
