#!/usr/bin/env python3
"""Host cost of the port's ``gmm`` wrapper, and its ring depth, on one card;
with ``--scan``, ``backlog_scan`` on a plane that never coalesces; with
``--deposit``, ``deposit`` on the fleet's tables; with ``--ctrl``, the
admission controller's kernels on synthetic inputs.

    python3 gmm_bench.py                   # the port in this checkout
    python3 gmm_bench.py --src TREE/src    # the port in another tree
    python3 gmm_bench.py --scan [--src TREE/src]
    python3 gmm_bench.py --deposit [--src TREE/src]
    python3 gmm_bench.py --ctrl [--src TREE/src]

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

With ``--scan`` it prints one object a layout instead: ``backlog_scan``'s
device ms (three readings of ``time_ms``) on the fleet ``run()`` plane's
shape (40,966 bins x 864 columns) filled by
``chip_smoke.never_coalescing_plane`` at ``QueueConfig()``'s cap and bin
width, where a chunked scan has to re-run every chunk in turn, and whether
it is bitwise the plain loop; once laid out as the fleet passes it (a
transposed view, bins contiguous) and once time-major.  A wrapper that
copies a layout to the one its kernel reads is timed with the copy.  Run
it on two trees in one call to compare their kernels there.

With ``--deposit`` it builds ``chip_smoke.py``'s fleet world, keeps the
tables ``run()`` and ``run_many`` (11 fractions) hand to ``deposit`` on
their first call, and prints one object a table: whether ``deposit`` is
bitwise its plain version there, the least time the card could take
(``chip_smoke.deposit_bound``), its device ms (three readings of
``time_ms``) and, from ``torch.profiler``, the device ms of each CUDA
kernel a call launches.  Then one object for a single row of one
``deposit.TILE``-bin tile holding 140,800 triples, all on one cell
("pile", a chain of dependent adds) or on 32 different cells a step
("distinct"): the ns per triple of that one bucket's work.  Run it on two
trees in one call to compare their kernels on the same tables.

With ``--ctrl`` it prints one object an input, at the shapes of the
admission ``run()`` on the paper's world (``chip_smoke.py`` phase 9: T =
60,054 bins, 864 compact rows, 3 plans of 32 layers x 8 experts, 200
topology slots, a control bin every 10 bins, 8 gateways), from seeded
random numbers: ``admission_window`` on wait planes of F = 1 and 4
entries (where the tree has it), and ``admission_ctrl`` on window tensors
of F = 1 and 4 laid out as ``admission_window`` returns them (each
(entry, plan)'s windows contiguous; a tree whose wrapper copies them to
another layout is timed with the copy): every window over the target,
every window under it, a random mix, and
``chip_smoke.never_coalescing_windows`` (AIMD, PID):
whether each is bitwise its plain version, the least time the card
could take and the device ms (three readings of ``time_ms``).  Run it on
two trees in one call to compare their kernels on the same inputs.

Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

import chip_smoke

D, F, E = 4096, 1376, 8
DEPTHS = (2, 3, 4, 0)
SCAN_SHAPE = (40_966, 864)      # FleetSim.run()'s plane on the paper's world
SCAN_CAP, SCAN_DT = 10.0, 0.05  # QueueConfig(): buffer_s, dt_s


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


def _scan(torch) -> None:
    from repro_torch.kernels import backlog_scan
    for time_major in (False, True):
        work = chip_smoke.never_coalescing_plane(
            torch, SCAN_SHAPE, SCAN_CAP, SCAN_DT, time_major=time_major)
        got = backlog_scan.backlog_scan(work, SCAN_CAP, SCAN_DT)
        want = backlog_scan.backlog_scan_plain(work.contiguous(), SCAN_CAP,
                                               SCAN_DT)
        print(json.dumps({
            "scan": "never coalescing", "shape": list(SCAN_SHAPE),
            "layout": "time-major" if time_major else "fleet view",
            "equal": bool(torch.equal(got, want)),
            "bound_ms": chip_smoke.bound(8 * work.numel(), 4 * work.numel(),
                                         "float32")[0],
            "ms": [chip_smoke.time_ms(torch, lambda: backlog_scan.backlog_scan(
                work, SCAN_CAP, SCAN_DT), 5)[0] for _ in range(3)]}),
            flush=True)


def _deposit(torch) -> None:
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import deposit
    from repro_torch.traffic import queueing
    sim, _ = chip_smoke.build_fleet(chip_smoke.fleet_world(), "cuda")
    masks = (np.random.default_rng(1).random(sim.n_requests)[None, :]
             < np.asarray(chip_smoke.FLEET_FRACTIONS)[:, None])
    tables, real = {}, queueing.deposit

    def keep(key):
        def rec(rows, cols, vals, n_rows, n_cols, row_ptr):
            tables.setdefault(key, (rows.clone(), cols.clone(), vals.clone(),
                                    n_rows, n_cols, row_ptr.clone()))
            return real(rows, cols, vals, n_rows, n_cols, row_ptr=row_ptr)
        return rec
    try:
        queueing.deposit = keep("run()")
        sim.run()
        queueing.deposit = keep("run_many")
        sim.run_many(masks)
    finally:
        queueing.deposit = real
    del sim
    n = 140_800                  # one bucket: a single row and tile
    gen = torch.Generator(device="cuda").manual_seed(0)
    one = torch.rand(n, dtype=torch.float64, device="cuda", generator=gen) + 1
    tile = getattr(deposit, "TILE", 512)
    for what, cols in (("pile", torch.full((n,), 100, device="cuda")),
                       ("distinct", torch.arange(n, device="cuda") % 32)):
        tables[f"one row, one tile, {what}"] = (
            torch.zeros(n, dtype=torch.int64, device="cuda"), cols, one, 1,
            tile, torch.tensor([0, n], device="cuda"))
    for what, (rows, cols, vals, n_rows, n_cols, row_ptr) in tables.items():
        def call():
            return deposit.deposit(rows, cols, vals, n_rows, n_cols,
                                   row_ptr=row_ptr)
        equal = bool(torch.equal(call(), deposit.deposit_plain(
            rows, cols, vals, n_rows, n_cols)))
        rec = {"deposit": what, "triples": int(row_ptr[-1]),
               "plane": [n_rows, n_cols], "equal": equal,
               "bound_ms": chip_smoke.deposit_bound(int(row_ptr[-1]), n_rows,
                                                    n_cols)[0],
               "ms": [chip_smoke.time_ms(torch, call, 5)[0] for _ in range(3)]}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        rec["kernel_ms"] = {re.search(r"deposit_\w*kernel", key).group(0): ms
                            for ms, _, key in chip_smoke.device_times(prof, 1)
                            if re.search(r"deposit_\w*kernel", key)}
        if n_rows == 1:
            rec["ns_per_triple"] = {k: v * 1e6 / n
                                    for k, v in rec["kernel_ms"].items()}
        print(json.dumps(rec), flush=True)


CTRL_BINS, CTRL_EVERY, CTRL_ROWS = 60_054, 10, 864  # phase 9's run()
CTRL_PLANS, CTRL_LAYERS, CTRL_EXPERTS, CTRL_SLOTS = 3, 32, 8, 200
CTRL_GATEWAYS = 8


def _ctrl(torch) -> None:
    from repro_torch.kernels import admission_ctrl
    gen = torch.Generator(device="cuda").manual_seed(0)
    t, n_ctrl = CTRL_BINS, CTRL_BINS // CTRL_EVERY
    try:
        from repro_torch.kernels import admission_window
    except ImportError:
        admission_window = None
    if admission_window is not None:
        per = CTRL_LAYERS * (1 + CTRL_EXPERTS)
        stations = torch.randint(0, CTRL_ROWS, (CTRL_SLOTS, CTRL_PLANS, per),
                                 generator=gen, device="cuda")
        gw = stations[..., :CTRL_LAYERS].contiguous()
        ex = stations[..., CTRL_LAYERS:].contiguous()
        slot = torch.arange(t, device="cuda") * CTRL_SLOTS // t
        ctrl = (torch.arange(t, device="cuda") + 1) % CTRL_EVERY == 0
        seg, n_win = admission_window.control_segments(ctrl)
        for f in (1, 4):
            wait = torch.rand((t, f, CTRL_ROWS), generator=gen, device="cuda")
            last = torch.rand((f, CTRL_ROWS), generator=gen, device="cuda")
            args = (wait, last, 10.0, 0.05, gw.int(), ex.int(), slot.int(),
                    seg.int(), n_win)
            got = admission_window.admission_window(*args)
            print(json.dumps({
                "admission_window": f"random wait ({t}, {f}, {CTRL_ROWS})",
                "equal": bool(torch.equal(
                    got, admission_window.admission_window_plain(*args))),
                "bound_ms": chip_smoke.window_bound(
                    wait, last, (gw, ex), n_win, seg)[0],
                "ms": [chip_smoke.time_ms(torch, lambda: admission_window
                                          .admission_window(*args), 20)[0]
                       for _ in range(3)]}), flush=True)
    for f in (1, 4):
        # k-contiguous, as admission_window hands them to admission_ctrl
        base = torch.rand((f, CTRL_PLANS, n_ctrl), generator=gen,
                          device="cuda").permute(2, 0, 1)
        cell = (torch.rand((CTRL_PLANS, CTRL_GATEWAYS), generator=gen,
                           device="cuda") * 2.0,
                torch.rand((CTRL_PLANS,), generator=gen, device="cuda") * 0.5,
                torch.ones((f, CTRL_PLANS, CTRL_GATEWAYS), device="cuda"),
                torch.full((f,), 4.0, device="cuda"),
                torch.full((f,), float("inf"), device="cuda"))
        cases = {"over": (base * 100.0 + 10.0, cell),
                 "under": (base * 0.01, cell),
                 "mixed": (base * 6.0, cell)}
        for policy in ("aimd", "pid"):
            kw = dict(increase=0.1, decrease=0.6, admit_min=0.05, pid=None)
            if policy == "pid":
                kw["pid"] = dict(kp=0.4, ki=0.05, kd=0.0, gain=torch.ones(
                    CTRL_PLANS, device="cuda"))
            items = list(cases.items())
            if f == 1:
                win, cell_n, kw_n = chip_smoke.never_coalescing_windows(
                    torch, n_ctrl, f, CTRL_PLANS, CTRL_GATEWAYS, policy)
                items.append(("never coalescing", (win, cell_n)))
            for what, (win, args) in items:
                k = kw_n if what == "never coalescing" else kw

                def call():
                    return admission_ctrl.admission_ctrl(win, *args, **k)
                got = call()
                want = admission_ctrl.admission_ctrl_plain(win, *args, **k)
                nbytes = 4 * (win.numel() + got.numel()
                              + sum(a.numel() for a in args))
                print(json.dumps({
                    "admission_ctrl": f"{policy} {what}, win {tuple(win.shape)}"
                                      f" -> {tuple(got.shape)}",
                    "equal": bool(torch.equal(got, want)),
                    "bound_ms": chip_smoke.bound(nbytes, 0, "float32")[0],
                    "ms": [chip_smoke.time_ms(torch, call, 20)[0]
                           for _ in range(3)]}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(chip_smoke.ROOT / "src"),
                    help="the src directory of the port to measure")
    ap.add_argument("--scan", action="store_true",
                    help="time backlog_scan on a never-coalescing plane")
    ap.add_argument("--deposit", action="store_true",
                    help="time deposit on the fleet's run() and run_many "
                         "tables")
    ap.add_argument("--ctrl", action="store_true",
                    help="time admission_window and admission_ctrl on "
                         "synthetic inputs at the admission run()'s shapes")
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
    if args.scan:
        _scan(torch)
        return 0
    if args.deposit:
        _deposit(torch)
        return 0
    if args.ctrl:
        _ctrl(torch)
        return 0
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
