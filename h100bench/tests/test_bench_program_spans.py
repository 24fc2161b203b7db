"""The readers of the program's spans and counters, on a synthetic traced
unit: a device window with a prefill and two decode segments, the
program's span records on the same clock (one decode step of an earlier,
dropped trace before the window), and its counts."""
import types

import pytest

from h100bench import harness
from h100bench.metrics import _program
from repro_torch.obs import spans

B = 1_000_000_000_000           # the window opens at 1,000 s, in ns
MS = 1_000_000


def _s(name, a_ms, b_ms, sid, parent, unit):
    return spans.Span(name, B + round(a_ms * MS), B + round(b_ms * MS), sid,
                      parent, unit, 1, {})


def _c(name, unit, value):
    return spans.Count(name, unit, value)


# Device kernels, in seconds: idle gaps in decode are [5.0, 6.0],
# [6.5, 8.0] and [9.0, 10.0] ms after the window opens (3.5 ms).
TRACED = {
    "window": (1000.0, 1000.010),
    "starts": [1000.0, 1000.004, 1000.007],
    "segments": [
        ("prefill", [("k", 1000.0005, 1000.0035)]),
        ("decode", [("k", 1000.0045, 1000.005), ("k", 1000.006, 1000.0065)]),
        ("decode", [("k", 1000.008, 1000.009)]),
    ],
}

SPANS = [
    _s("decode_step", -50, -40, 5, None, 5),          # the dropped trace's
    _s("moe", -48, -41, 6, 5, 5),
    _s("prefill", 0.1, 3.0, 1, None, 1),
    _s("decode_step", 4.0, 6.8, 10, None, 10),
    _s("block", 4.1, 6.7, 11, 10, 10),
    _s("attn", 4.2, 5.2, 12, 11, 10),
    _s("moe", 5.3, 6.6, 13, 11, 10),
    _s("decode_step", 7.2, 9.5, 20, None, 20),
    _s("attn", 7.5, 8.0, 22, 20, 20),
    _s("moe", 8.1, 9.4, 23, 20, 20),
]

COUNTS = [
    _c("moe.copies_routed", 5, 100), _c("moe.copies_dropped", 5, 50),
    _c("moe.copies_routed", 1, 1000), _c("moe.copies_dropped", 1, 2),
    _c("moe.copies_routed", 10, 100), _c("moe.copies_dropped", 10, 3),
    _c("moe.copies_routed", 20, 100),
    _c("moe.copies_dropped", 20, lambda: 1),
]


@pytest.fixture
def store():
    spans.clear()
    spans._spans.extend(SPANS)
    spans._counts.extend(COUNTS)
    yield
    spans.clear()


def _run(kind="generate", traced=TRACED):
    return types.SimpleNamespace(traffic={"kind": kind}, traced=traced)


def _read(metric, run):
    return harness.reader(metric)(run)


def test_per_step_host_ms_leave_out_the_dropped_trace(store):
    run = _run()
    assert _read("decode_moe_host_ms.gen", run) == pytest.approx(1.3)
    assert _read("decode_attn_host_ms.gen", run) == pytest.approx(0.75)


def test_idle_in_spans_splits_the_decode_gaps(store):
    # [5, 6] in step 10; [6.5, 8] in steps 10 and 20 for 0.3 + 0.8;
    # [9, 10] in step 20 for 0.5: 2.6 of 3.5 ms.
    assert _read("idle_in_spans_pct.gen", _run()) == \
        pytest.approx(100 * 2.6 / 3.5)
    assert _program.idle_gaps_ns(_run(), "prefill") == [
        (B, B + MS // 2), (B + 3_500_000, B + 4_500_000)]


def test_dropped_copies_count_the_kind_of_unit(store):
    assert _read("dropped_copies_pct.gen", _run()) == pytest.approx(2.0)
    assert _read("dropped_copies_pct.prefill", _run("prefill")) == \
        pytest.approx(0.2)
    assert _read("dropped_copies_pct.train", _run("train")) is None


def test_train_readers(store):
    spans._spans.extend([_s("train_step", 0.2, 9.8, 30, None, 30),
                         _s("forward_backward", 0.3, 6.0, 31, 30, 30),
                         _s("adamw", 6.1, 9.7, 32, 30, 30)])
    traced = {"window": TRACED["window"], "starts": [1000.0],
              "segments": [("train_step", [k for _, seg in TRACED["segments"]
                                           for k in seg])]}
    run = _run("train", traced)
    assert _read("adamw_host_ms.train", run) == pytest.approx(3.6)
    # Idle 0.5 + 1 + 1 + 1.5 + 1 = 5 ms; the spans hold all but [0, 0.1]
    # and [9.8, 10] of it.
    assert _read("idle_in_spans_pct.train", run) == \
        pytest.approx(100 * 4.7 / 5.0)


def test_nothing_to_read_gives_none(store, monkeypatch):
    names = ["decode_moe_host_ms.gen", "decode_attn_host_ms.gen",
             "idle_in_spans_pct.gen", "dropped_copies_pct.gen"]
    for name in names:
        assert _read(name, _run(traced=None)) is None
    outside = dict(TRACED, window=(2000.0, 2000.010))
    for name in names:
        assert _read(name, _run(traced=outside)) is None
    monkeypatch.setattr(_program, "spans_module", lambda: None)
    for name in names + ["adamw_host_ms.train"]:
        assert _read(name, _run()) is None


def test_a_unit_the_window_cuts_is_left_out(store):
    spans._spans.extend([_s("decode_step", 9.6, 12.0, 40, None, 40),
                         _s("moe", 9.7, 11.0, 41, 40, 40)])
    spans._counts.extend([_c("moe.copies_routed", 40, 100),
                          _c("moe.copies_dropped", 40, 100)])
    assert _read("decode_moe_host_ms.gen", _run()) == pytest.approx(1.3)
    assert _read("dropped_copies_pct.gen", _run()) == pytest.approx(2.0)
