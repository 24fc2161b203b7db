"""idle_in_spans_pct.<kind>: the share of the device's idle time in the
traced unit's decode segments (generation) or its train step during
which one of the program's spans was open on the host, on the shared
clock, in %.  The rest is the harness's own work between the program's
calls."""
from h100bench.metrics._program import idle_gaps_ns, spans_module, unit_spans

SEGMENT = {"generate": "decode", "train": "train_step"}


def read(run):
    label = SEGMENT.get(run.traffic["kind"])
    recs = unit_spans(run)
    if label is None or recs is None:
        return None
    gaps = idle_gaps_ns(run, label)
    idle = sum(b - a for a, b in gaps)
    if idle <= 0:
        return None
    outside = spans_module().attribute(recs, gaps).get(None, 0)
    return 100.0 * (idle - outside) / idle
