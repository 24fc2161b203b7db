"""gmm_roofline.<kind>: the least time the routed experts need (the cell's
family's ``gmm_need``: every token's top_k copies through gate, up and
down; in training also their dx and dw) over the ``gmm`` kernels' device
time in the traced unit, in %."""
from h100bench import yardstick
from h100bench.metrics._common import segment_kernels

SEGMENT = {"prefill": "prefill", "train": "train_step"}


def read(run):
    t = run.traffic
    label = SEGMENT.get(t["kind"])
    if not run.traced or label is None:
        return None
    tokens = t["batch"] * t.get("prompt_len", t.get("seq_len", 0))
    flops, nbytes = run.cell.family.gmm_need(run.sizes, tokens,
                                             backward=t["kind"] == "train")
    busy = yardstick.kernel_seconds(segment_kernels(run, label), "gmm_")
    if busy <= 0:
        return None
    return 100.0 * yardstick.least_time_s(flops, nbytes) / busy
