"""Helpers of the readers of the program's own spans and counters
(``repro_torch.obs.spans``, recorded while the traced unit's profiler
ran, on the device trace's clock); not a reader.  A checkout whose
program has no such module gives them nothing to read."""
from h100bench import yardstick

# The program's span that opens each unit of a kind of job.
UNIT = {"prefill": "prefill", "generate": "decode_step", "train": "train_step"}


def spans_module():
    try:
        from repro_torch.obs import spans
    except ImportError:
        return None
    return spans


def window_ns(run) -> tuple[int, int]:
    lo, hi = run.traced["window"]
    return round(lo * 1e9), round(hi * 1e9)


def unit_spans(run):
    """The program's spans that overlap the traced unit's window (a
    dropped trace's unit lies before the primer, outside it), or None."""
    spans = spans_module()
    if spans is None or not run.traced:
        return None
    return spans.records(*window_ns(run)) or None


def units_in_window(run, unit: str) -> set[int]:
    """Ids of the program's ``unit`` spans (a prefill, a decode step, a
    train step) that end inside the traced unit's window: the units its
    device trace holds whole (each starts just after its segment's
    marker is launched, which may be a few us before the marker ran)."""
    recs = unit_spans(run)
    if recs is None:
        return set()
    lo, hi = window_ns(run)
    return {s.id for s in recs if s.name == unit and lo <= s.end_ns <= hi}


def per_unit_ms(run, unit: str, name: str):
    """Host ms inside ``name`` spans, summed, over the ``unit`` spans of
    the traced unit (``units_in_window``) that hold them."""
    units = units_in_window(run, unit)
    if not units:
        return None
    held = sum(s.end_ns - s.start_ns for s in spans_module().records()
               if s.name == name and s.unit in units)
    return held / 1e6 / len(units)


def idle_gaps_ns(run, label: str) -> list[tuple[int, int]]:
    """(start_ns, end_ns) of the device's idle gaps in the traced unit's
    segments labelled ``label``, a gap going to the segment it starts in
    (as ``harness.breakdown`` puts them)."""
    tr = run.traced
    kernels = [(a, b) for _, seg in tr["segments"] for _, a, b in seg]
    labels = [lab for lab, _ in tr["segments"]]
    out = []
    for start, length in yardstick.idle_gaps(kernels, *tr["window"]):
        at = labels[0]
        for lab, b0 in zip(labels, tr["starts"]):
            if start >= b0:
                at = lab
        if at == label:
            out.append((round(start * 1e9), round((start + length) * 1e9)))
    return out
