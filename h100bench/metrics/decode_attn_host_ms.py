"""decode_attn_host_ms.<kind>: host ms a decode step spends in the
program's ``attn`` spans (every block's attention mixer: projections,
rope, the cache write and ``decode_attention``), over the traced unit's
``decode_step`` spans."""
from h100bench.metrics._program import per_unit_ms


def read(run):
    return per_unit_ms(run, "decode_step", "attn")
