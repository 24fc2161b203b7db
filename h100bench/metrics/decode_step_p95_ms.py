"""decode_step_p95_ms.<kind>: the 95th percentile (nearest rank) of the
window's gaps between output tokens of the decode steps, in ms."""
from h100bench import yardstick


def read(run):
    if len(run.decode_spans) < 20:
        return None
    return 1e3 * yardstick.percentile(run.decode_spans, 95)
