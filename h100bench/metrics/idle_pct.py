"""idle_pct.<kind>: the share of the traced unit's device window in which
no kernel ran, in %."""


def read(run):
    tr = run.traced
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
