"""launches_per_step.<kind>: kernels the device ran in the traced unit's
decode steps (memory copies and sets left out) over the steps; the count
repeats exactly from step to step."""
from h100bench.metrics._common import n_segments, segment_kernels


def read(run):
    if not run.traced:
        return None
    steps = n_segments(run, "decode")
    if steps == 0:
        return None
    kernels = [e for e in segment_kernels(run, "decode")
               if not e[0].startswith(("Memcpy", "Memset"))]
    return len(kernels) / steps
