"""decode_attn_roofline.<kind>: the least time the decode steps' attention
needs (the cell's family's ``decode_attn_row_bytes``: every row's K and V
rows [0, pos] of every layer read once, q read and the output written
once) over the ``decode_attention`` kernels' device time in the traced
unit, in %."""
from h100bench import yardstick
from h100bench.metrics._common import decode_positions, segment_kernels


def read(run):
    if not run.traced:
        return None
    b = run.traffic["batch"]
    nbytes = sum(yardstick.decode_attn_bytes(run.cell.family, run.sizes,
                                             [p] * b)
                 for p in decode_positions(run))
    busy = yardstick.kernel_seconds(segment_kernels(run, "decode"),
                                    "decode_attn")
    if busy <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / yardstick.HBM_BYTES_PER_S / busy
