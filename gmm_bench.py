#!/usr/bin/env python3
"""Host cost of the port's ``gmm`` wrapper, and its ring depth, on one card.

    python3 gmm_bench.py                   # the port in this checkout
    python3 gmm_bench.py --src TREE/src    # the port in another tree

At llama-moe-3.5b's bf16 serve shapes (E = 8, K/N = 4096/1376 and
1376/4096, C = 2 and 40) it prints one JSON object a line:

  * ``host_us``: the host's time to enqueue one ``moe_gmm.gmm`` call, and
    ``bmm_host_us`` for ``torch.bmm`` on the same inputs (``host_us`` of
    ``chip_smoke.py``).  Run it on two trees in one call to compare their
    wrappers.
  * where the tree has ``moe_gmm.gmm_depth``: ``gmm``'s device ms at the
    ring depth it picks and at the other depths (0: the whole ring), each
    timed in turns with ``torch.bmm`` (``time_ms`` and ``bound`` of
    ``chip_smoke.py``), and whether each depth's result is bitwise that
    of the chosen depth.

Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import chip_smoke

D, F, E = 4096, 1376, 8
DEPTHS = (2, 3, 4, 0)


def _inputs(torch, c, k, n):
    gen = torch.Generator(device="cuda").manual_seed(c * 7 + n)
    x = torch.randn(E, c, k, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(E, k, n, generator=gen, device="cuda") / k ** 0.5
         ).to(torch.bfloat16)
    return x, w


def _depths(torch, moe_gmm, x, w, rec) -> None:
    """Device ms at each ring depth, in turns with torch.bmm."""
    chosen = moe_gmm.gmm_depth
    e, c, k = x.shape
    pick = chosen(e, c, w.shape[2])
    want = moe_gmm.gmm(x, w)
    rec["depth"], rec["depths"] = pick, []
    try:
        for depth in (pick,) + tuple(d for d in DEPTHS if d != pick):
            moe_gmm.gmm_depth = lambda *_, d=depth: d
            times = {"ms": [], "bmm_ms": []}
            for key, fn in (("ms", lambda: moe_gmm.gmm(x, w)),
                            ("bmm_ms", lambda: torch.bmm(x, w))) * 2:
                times[key].append(chip_smoke.time_ms(torch, fn, 50)[0])
            same = bool(torch.equal(moe_gmm.gmm(x, w), want))
            rec["depths"].append(dict(depth=depth, same=same, **times))
    finally:
        moe_gmm.gmm_depth = chosen


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(chip_smoke.ROOT / "src"),
                    help="the src directory of the port to measure")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("gmm_bench: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import build, moe_gmm
    print(json.dumps({"card": chip_smoke.card_line(),
                      "port": str(Path(moe_gmm.__file__).resolve())}),
          flush=True)
    build.load("moe_gmm")
    for c in (2, 40):
        for k, n in ((D, F), (F, D)):
            x, w = _inputs(torch, c, k, n)
            nbytes = 2 * (x.numel() + w.numel() + E * c * n)
            rec = {"shape": [E, c, k, n],
                   "bound_ms": chip_smoke.bound(nbytes, 2.0 * E * c * k * n,
                                                "bfloat16")[0],
                   "host_us": [chip_smoke.host_us(torch, lambda: moe_gmm.gmm(x, w))
                               for _ in range(3)],
                   "bmm_host_us": [chip_smoke.host_us(torch, lambda: torch.bmm(x, w))
                                   for _ in range(3)]}
            if hasattr(moe_gmm, "gmm_depth"):
                _depths(torch, moe_gmm, x, w, rec)
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
