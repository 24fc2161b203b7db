"""decode_step_ms.<kind>: the window's decode steps' host time (each step
from the previous token to its own, ended by a synchronise) over their
number, in ms."""


def read(run):
    if not run.decode_spans:
        return None
    return 1e3 * sum(run.decode_spans) / len(run.decode_spans)
