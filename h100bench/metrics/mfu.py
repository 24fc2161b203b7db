"""mfu.<kind>: the window's model flops (``yardstick``'s count: no
recompute, padding or masked work) over the window's length times the
bf16 peak, in %."""
from h100bench import yardstick
from h100bench.metrics._common import unit_flops


def read(run):
    if run.window_s <= 0 or run.units == 0:
        return None
    return 100.0 * run.units * unit_flops(run) / (
        run.window_s * yardstick.PEAK_BF16_FLOPS)
