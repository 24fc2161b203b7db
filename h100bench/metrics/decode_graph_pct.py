"""decode_graph_pct.<kind>: 100 x the decode steps the program replayed
from a CUDA graph (its ``serve.graph_replays`` counter) over the traced
unit's ``decode_step`` units, in %.  A program that counts no
``serve.graph_*`` has nothing to read here."""
from h100bench.metrics._program import spans_module, units_in_window


def read(run):
    units = units_in_window(run, "decode_step")
    if not units:
        return None
    got = spans_module().counters(units=units)
    if not any(k.startswith("serve.graph_") for k in got):
        return None
    return 100.0 * got.get("serve.graph_replays", 0) / len(units)
