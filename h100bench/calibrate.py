"""Readings that set a cell's limits, on the card, in one process: the
check's numbers of the program on ``--seeds`` (sound runs: their largest
is the lower reading) and of the control, the reference computed in fp8
in the program's place, on ``--control-seeds`` (their smallest is the
upper reading).  Each seed runs the cell's set-up and one unit of its
timed path at the cell's own sizes, then the check.

    python3 h100bench/calibrate.py --workload granite-moe-3b-a800m.rag-2k \
        --seeds 101 102 103 --control-seeds 201 202 203

Prints one JSON line a seed, then the largest sound and the smallest
control reading of each number.  With ``--faults`` the program's runs
carry those faults (``harness.FAULTS``), and their readings are a
fault's.  A benchmark run never runs this.
"""
import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="h100bench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[],
                    help="faults planted in the timed path of every seed "
                         "(harness.FAULTS): their readings")
    args = ap.parse_args(argv)
    from h100bench import harness
    sound: dict = {}
    low: dict = {}
    for seed, control in ([(s, False) for s in args.seeds]
                          + [(s, True) for s in args.control_seeds]):
        out = harness.run_cell(args.workload, seed, 0.0, False,
                               control=control, faults=args.faults,
                               readings=True)
        line = {"seed": seed, "correct": out["correct"],
                "checks": out["readings"],
                "metrics": {k: v["value"] for k, v in out["metrics"].items()}}
        for k, v in line["checks"].items():
            sound.setdefault(k, []).append(v)
        if control:
            line["control"] = out["control"]
            for k, v in out["control"].items():
                low.setdefault(k, []).append(v)
        print(json.dumps(line), flush=True)
        del out
        gc.collect()
    print(json.dumps({"lower": {k: max(v) for k, v in sound.items()},
                      "upper": {k: min(v) for k, v in low.items()},
                      "n_sound": len(next(iter(sound.values()), [])),
                      "n_control": len(next(iter(low.values()), []))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
