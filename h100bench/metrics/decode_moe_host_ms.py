"""decode_moe_host_ms.<kind>: host ms a decode step spends in the
program's ``moe`` spans (routing, dispatch, the experts, the combine and
the shared experts of every MoE block), over the traced unit's
``decode_step`` spans."""
from h100bench.metrics._program import per_unit_ms


def read(run):
    return per_unit_ms(run, "decode_step", "moe")
