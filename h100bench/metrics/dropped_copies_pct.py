"""dropped_copies_pct.<kind>: 100 x the program's ``moe.copies_dropped``
over ``moe.copies_routed`` (token copies beyond their expert's capacity,
over those routed), counted in the traced unit's prefill, decode steps
(generation: its prefill left out) or train step (the forward's routing;
the recompute is not counted)."""
from h100bench.metrics._program import UNIT, spans_module, units_in_window


def read(run):
    units = units_in_window(run, UNIT[run.traffic["kind"]])
    if not units:
        return None
    got = spans_module().counters(units=units)
    routed = got.get("moe.copies_routed", 0)
    if routed <= 0:
        return None
    return 100.0 * got.get("moe.copies_dropped", 0) / routed
