"""Run one benchmark cell once and print its result as the last line of
standard output (a JSON object), from the root of a checkout:

    python3 h100bench/run.py --workload deepseek-moe-16b.prefill-256 \
        --seed 1234 --seconds 30 --trace 0

Exits 2, printing no result, without the CUDA devices the cell needs,
and 3 if a forbidden package (``harness.FORBIDDEN``) was loaded.  The
numbers the check compared go to standard error last, each with its
limit, and into the result's last key, ``checks``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="h100bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from h100bench import harness
    try:
        out = harness.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), t_start=T_START)
    except harness.NoChip as err:
        print(f"h100bench: {err}", file=sys.stderr)
        return 2
    bad = harness.forbidden_modules()
    if bad:
        print(f"h100bench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
