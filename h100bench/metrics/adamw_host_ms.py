"""adamw_host_ms.<kind>: host ms of the program's ``adamw`` span (the
optimizer's update of every leaf) a train step, over the traced unit."""
from h100bench.metrics._program import per_unit_ms


def read(run):
    return per_unit_ms(run, "train_step", "adamw")
