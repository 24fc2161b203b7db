"""``decode_graph_pct``, the share of decode steps the program replayed
from a CUDA graph, on the synthetic traced unit of
``test_bench_program_spans.py`` (decode steps 10 and 20 inside the
window, step 5 of a dropped trace before it)."""
import pytest

from h100bench.metrics import _program
from h100bench.tests.test_bench_program_spans import (  # noqa: F401
    _c, _read, _run, store)
from repro_torch.obs import spans

NAME = "decode_graph_pct.gen"


def test_a_program_without_the_graph_reads_none(store, monkeypatch):
    # The store's counts are the MoE's only, as a parent's program counts.
    assert _read(NAME, _run()) is None
    assert _read(NAME, _run(traced=None)) is None
    monkeypatch.setattr(_program, "spans_module", lambda: None)
    assert _read(NAME, _run()) is None


@pytest.mark.parametrize("counts,want", [
    ([("serve.graph_replays", 10), ("serve.graph_eager", 20)], 50.0),
    ([("serve.graph_captures", 10), ("serve.graph_replays", 10),
      ("serve.graph_replays", 20)], 100.0),
    ([("serve.graph_eager", 10), ("serve.graph_eager", 20)], 0.0),
])
def test_replays_over_the_windows_decode_steps(store, counts, want):
    # Step 5's replay lies before the window and is left out.
    spans._counts.append(_c("serve.graph_replays", 5, 1))
    spans._counts.extend(_c(name, unit, 1) for name, unit in counts)
    assert _read(NAME, _run()) == pytest.approx(want)
