"""Helpers the metric readers share (not a reader: no metric has this
name)."""
from h100bench import yardstick


def decode_positions(run) -> list[int]:
    """Positions of a unit's decode steps, in order."""
    t = run.traffic
    return [t["prompt_len"] + j for j in range(t.get("gen_tokens", 1) - 1)]


def segment_kernels(run, label: str) -> list:
    """The traced unit's kernels in the segments labelled ``label``."""
    return [e for lab, seg in run.traced["segments"] if lab == label
            for e in seg]


def n_segments(run, label: str) -> int:
    return sum(1 for lab, _ in run.traced["segments"] if lab == label)


def unit_flops(run) -> float:
    """Model flops of one unit of the run's traffic, by the cell's
    family's counts."""
    fam, s, t = run.cell.family, run.sizes, run.traffic
    kind = t["kind"]
    if kind == "train":
        return yardstick.train_flops(fam, s, t["batch"], t["seq_len"])
    flops = yardstick.prefill_flops(fam, s, t["batch"], t["prompt_len"])
    return flops + sum(yardstick.decode_flops(fam, s, t["batch"], p)
                       for p in decode_positions(run))
