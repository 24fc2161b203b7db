#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no success line):

  1. the card: ``nvidia-smi`` name and power limit, torch's device name;
  2. build: compile every kernel of the serve path from ``csrc/`` with
     nvcc for sm_90a (one nvcc per source, started together);
  3. kernels: each CUDA kernel against its plain PyTorch version on the
     card at the serve path's shapes (plus an f32, a ragged and a long
     case, decode_attention's S = 2048 both in its own layout and as a
     view of the model's cache, and gmm at a real prefill's C = 2560),
     with its device time
     (CUDA events around calls queued behind a busy card) and wall time
     (CUDA events, host gaps included), the same for the plain version
     and for one PyTorch library call as a yardstick (gmm and
     ``torch.bmm`` timed in turns), and the least time the card could
     take; gmm's lines also give the kernel path taken, the rate
     reached against the bound (TB/s or TFLOP/s) and the host's time to
     enqueue one call (``host_us``, and ``torch.bmm``'s);
  4. small input: the serve path at smoke size on the card (kernels)
     against the same weights on the CPU (plain versions);
  5. full serve: ``repro_torch.launch.serve`` for llama-moe-3.5b at its
     published width and depth (batch 4, prompt 32, 16 decode tokens),
     with every kernel's launch count over that run checked, and every
     gmm launch on the tensor-core (wgmma) path;
  6. profile: where a full-width decode step's time goes (torch.profiler:
     device busy share, kernel time by name, ``decode_attention``'s);
  7. fleet: the request-level fleet simulator (``repro_torch.traffic
     .FleetSim``) on the paper's world (33 x 32 satellites, 200 slots,
     llama-moe-3.5b's 32 MoE layers, 8 experts top-2, 3 plans, ~132
     requests, analytic service, ``QueueConfig()``): built on the card,
     ``run()`` with the launch counts of ``deposit`` and ``backlog_scan``
     checked, the device busy share of one ``run()``, the host's time in
     ``run()`` itemized (``chunk_table``, the iteration-1 ``np.bincount``,
     the upload, the fixed point, ``_finalize``), ``run_many`` over 11
     thinning fractions, and the CPU (plain versions) held to the card
     on ``run()`` and on the two smallest fractions, which must serve
     requests;
  8. fleet kernels: ``deposit`` and ``backlog_scan`` on the inputs that
     ``run()`` and ``run_many`` gave them, each against its plain version
     (bitwise), with device times, the plain version's and the library
     call's time, and the least time the card could take; ``deposit``
     with its table's shape (triples per row, per (row, tile) bucket and
     on one cell, zero-valued share); ``backlog_scan`` also on a plane
     built never to coalesce, each plane with its chunks' coalescence
     statistics;
  9. fleet with ground and admission: phase 7's world behind the 8
     default gateways (``build_ground_segment``, 10 degrees), a 60 s
     Poisson trace at 2 requests/s over them, ``QueueConfig(admission=
     AdmissionConfig())``: ``run()`` under AIMD and under PID on the card
     (deposit 2, backlog_scan 3, admission_window 3, admission_ctrl 3
     launches), wall and device time, total launches beside the earlier
     gather-based controller's (1,203 launches, 47.4 ms of device time
     with copies, on an H100 at 700 W), the host
     itemized (with ``_build_admission_tables`` and the attempt resolve),
     each against the CPU (identical served, shed and retry sets,
     ``assert_parity``), then ``run_many`` over ``ttft_targets`` at 1.5,
     2, 3 and 5 x the zero-load p99 TTFT, card against CPU;
     ``admission_window`` bitwise against its plain version on every wait
     trace those runs gave it, timed beside its byte bound;
     ``admission_ctrl`` bitwise against its plain loop on every window
     tensor they gave it and on two built never to coalesce (AIMD, PID),
     each with its chunks' coalescence statistics, timed beside its byte
     and serial-chain bounds;
 10. fleet with batching and probes: phase 7's world under
     ``BatchingConfig(b_max=8)``: ``run()`` on the card (deposit 6,
     backlog_scan 3 launches), wall and device time, busy share, peak
     device memory, the host itemized, the batching law's device time
     and peak on ``run()``'s planes, ``deposit`` bitwise against its plain
     version on the decode-work and decode-visit tables ``run()`` gave it
     (timed beside its byte bound), the card against the CPU; then
     ``ProbeConfig()`` on that run and on phase 9's AIMD ``run()``:
     ``last_probes`` card against CPU on every channel, a probes-off
     ``run()`` afterwards bitwise as before, the flight log exported by
     ``chrome_trace`` and passed by ``validate_trace``, the record's cost;
     then the reference's batching frontier
     (``benchmarks/bench_batching.py`` at its non-fast setting, rebuilt
     with the port): FIFO and ``b_max=8``, each one ``run_many`` over 4
     thinning fractions, card against CPU, ``b_max=1`` bitwise FIFO, and
     batched goodput above FIFO at p99 TTFT <= 2.5 x the zero-load p99;
 11. re-placement and the joint control plane: (a) phase 7's world
     under ``ReplanConfig(mode="backlog", controller_iterations=2,
     hysteresis=0)`` over cadences 1, 2 and 3 in one
     ``run_many(replan=)`` (deposit 8, backlog_scan 9 launches), wall,
     peak memory, the host's time and each stage's device time
     itemized (``run_replan_grid(stage=)``), ``replan_traffic`` on the
     card at each cadence with decisions equal bit for bit and results
     at the fused-vs-legacy criterion, ``deposit`` bitwise on the gated
     table the grid gave it (its zero share beside its time); (b) the
     reference's ``benchmarks/bench_ctrl.py`` grid at its non-fast
     setting (27 cells: 3 cadences x 3 migration prices x 3 AIMD TTFT
     targets) in one ``run_replan_grid`` (deposit 5, backlog_scan,
     admission_window and admission_ctrl 6 launches each), card against
     CPU on every cell (decisions bit for bit; served, shed and retry
     sets), the host loop cell by cell against it (decisions bit for
     bit; its wall reported beside the grid's), both admission kernels
     bitwise against their plain versions on the per-entry tables the
     grid gave them; (c) that grid's cell 0 flight log with ``replan=``,
     its decisions as trace instants, through ``validate_trace``;
 12. the ``kernels`` JSON line (all six kernels; launches counted over
     the serve run for gmm/decode_attention, over the fleet ``run()``
     for deposit/backlog_scan and over the AIMD ``run()`` for
     admission_window/admission_ctrl), the card line, then the result
     line.  Each phase's seconds are printed as it ends.

Imports nothing of JAX and nothing of the ``repro`` package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ARCH = "llama-moe-3.5b"
BATCH, PROMPT, DECODE = 4, 32, 16
# H100 SXM data sheet: HBM rate and dense peak rates by type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "float64": 34e12}
# Thinning fractions of the fleet sweep (benchmarks/bench_fleet.py).
FLEET_FRACTIONS = (0.1, 0.15, 0.2, 0.25, 0.3, 0.35, 0.4, 0.5, 0.6, 0.8, 1.0)
# Latency targets of the admission sweep, times the zero-load p99 TTFT
# (benchmarks/bench_admission.py TARGET_SCALES).
ADM_TARGET_SCALES = (1.5, 2.0, 3.0, 5.0)
# The batching frontier of benchmarks/bench_batching.py: decode batch cap,
# nested thinning fractions, and the matched bound on p99 TTFT as a
# multiple of the zero-load p99.
BATCH_B_MAX = 8
BATCH_FRACTIONS = (0.25, 0.5, 0.75, 1.0)
BATCH_TTFT_BOUND_SCALE = 2.5
# The CUDA kernels each fleet wrapper call launches, by profiler name.
FLEET_KERNELS = {"deposit": ("deposit_bucket_kernel",
                             "deposit_accumulate_kernel"),
                 "backlog_scan": ("backlog_scan_kernel",)}


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def device_times(prof, n_calls: int) -> list[tuple[float, float, str]]:
    """(ms per call, launches per call, name) of every device-side event
    the profiler recorded, summed by name."""
    from torch.autograd import DeviceType
    return [(evt.self_device_time_total / 1e3 / n_calls, evt.count / n_calls,
             evt.key)
            for evt in prof.key_averages() if evt.device_type == DeviceType.CUDA]


def _events(torch, n: int):
    return [torch.cuda.Event(enable_timing=True) for _ in range(n)]


_SPIN_CYCLES_PER_MS: list[float] = []


def spin_cycles_per_ms(torch) -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on the card."""
    if not _SPIN_CYCLES_PER_MS:
        start, end = _events(torch, 2)
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        end.synchronize()
        _SPIN_CYCLES_PER_MS.append(20_000_000 / start.elapsed_time(end))
    return _SPIN_CYCLES_PER_MS[0]


def time_ms(torch, fn, iters: int, warmup: int = 3) -> tuple[float, float, bool]:
    """(device ms, wall ms, hidden) per call of ``fn()``.

    Wall ms: CUDA events around ``iters`` back-to-back calls, host gaps
    included.  Device ms: the same calls queued behind a spin kernel
    that keeps the card busy for twice their wall time, so that the
    events bracket the card's own work.  ``hidden`` says the host had
    queued every call before the spin ended, which makes device ms the
    card's time alone; a function that waits on the card inside (or
    whose calls take over a second) is not hidden, and its device ms
    includes host gaps.  (Per-window ``torch.profiler`` sums are not used
    here: late in this script short windows have come back with part or
    none of their kernels.)
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end, spin = _events(torch, 3)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    wall = start.elapsed_time(end) / iters
    if wall * iters > 1000.0:
        return wall, wall, False
    spin.record()
    torch.cuda._sleep(int(2.0 * wall * iters * spin_cycles_per_ms(torch)))
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t_host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    hidden = t_host_ms < 0.9 * spin.elapsed_time(start)
    return start.elapsed_time(end) / iters, wall, hidden


def host_us(torch, fn, n: int = 200) -> float:
    """Host time to enqueue one call of ``fn()``, microseconds: ``n``
    calls queued behind a spin long enough (0.5 ms a call) that the card's
    queue never makes the host wait."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(n * 0.5 * spin_cycles_per_ms(torch)))
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def event_ms(torch, fn, iters: int = 1, warm: bool = True) -> float:
    """Wall ms per call of ``fn()`` from CUDA events around ``iters``
    back-to-back calls (after one warm call if ``warm``), host gaps
    included."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start, end = _events(torch, 2)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_mem, t_ops) * 1e3, "bytes" if t_mem >= t_ops else "operations")


# --------------------------------------------------------------------- #
# Phase 3: kernels against their plain versions
# --------------------------------------------------------------------- #


def check_gmm(torch, e, c, k, n, dtype_name, iters):
    from repro_torch.kernels import moe_gmm
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(c * 7 + n)
    x = torch.randn(e, c, k, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(e, k, n, generator=gen, device="cuda") / k ** 0.5).to(dtype)
    before = dict(moe_gmm.path_launches)
    got = moe_gmm.gmm(x, w)
    torch.cuda.synchronize()
    path = [p for p in before if moe_gmm.path_launches[p] != before[p]]
    want = moe_gmm.gmm_plain(x, w)
    tol = 2e-2 if dtype_name == "bfloat16" else 2e-5
    err = float((got.float() - want.float()).abs().max())
    ok = bool(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol))
    esize = x.element_size()
    nbytes = (x.numel() + w.numel() + e * c * n) * esize
    flops = 2.0 * e * c * k * n
    b_ms, b_by = bound(nbytes, flops, dtype_name)
    rec = timed_record(
        torch, {"name": "gmm",
                "shape": f"x({e},{c},{k}) w({e},{k},{n}) {dtype_name}",
                "path": path[0] if len(path) == 1 else path,
                "max_abs_err": err, "tol": tol, "ok": ok and len(path) == 1,
                "bound_ms": b_ms, "bound_by": b_by},
        kernel=lambda: moe_gmm.gmm(x, w),
        plain=lambda: moe_gmm.gmm_plain(x, w),
        library=lambda: torch.bmm(x, w), iters=iters, turns=2)
    if b_by == "bytes":
        rec["rate"] = f"{nbytes / rec['ms'] / 1e9:.3f} TB/s"
    else:
        rec["rate"] = f"{flops / rec['ms'] / 1e9:.1f} TFLOP/s"
    rec["host_us"] = host_us(torch, lambda: moe_gmm.gmm(x, w))
    rec["library_host_us"] = host_us(torch, lambda: torch.bmm(x, w))
    return rec


def timed_record(torch, rec, kernel, plain, library, iters, turns=1) -> dict:
    """``rec`` with device and wall times of the kernel, its plain version
    and the library call.  With ``turns`` > 1 the kernel and the library
    call are timed in turns (kernel, library, kernel, ...) and each time
    is the mean of its turns, also listed under ``turns``."""
    runs: dict[str, list] = {"": [], "library_": []}
    for _ in range(turns):
        for key, fn in (("", kernel), ("library_", library)):
            runs[key].append(time_ms(torch, fn, iters))
    runs["plain_"] = [time_ms(torch, plain, iters)]
    for key, got in runs.items():
        rec[key + "ms"] = sum(r[0] for r in got) / len(got)
        rec[key + "wall_ms"] = sum(r[1] for r in got) / len(got)
        rec[key + "hidden"] = all(r[2] for r in got)
    if turns > 1:
        rec["turns"] = {"ms": [r[0] for r in runs[""]],
                        "library_ms": [r[0] for r in runs["library_"]]}
    return rec


def check_decode(torch, b, hkv, g, s, hd, dtype_name, pos_list, iters,
                 layout="bhsd"):
    """``layout`` "bshd": k and v are transposed views of the model's
    (B, S, Hkv, hd) cache, as ``models/attention.py`` passes them."""
    import torch.nn.functional as F

    from repro_torch.kernels import build, decode_attn
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(s + g)
    kv_shape = (b, hkv, s, hd) if layout == "bhsd" else (b, s, hkv, hd)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for shape in ((b, hkv, g, hd), kv_shape, kv_shape))
    if layout == "bshd":
        k, v = k.transpose(1, 2), v.transpose(1, 2)
    pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
    got = decode_attn.decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    want = decode_attn.decode_attention_plain(q, k, v, pos)
    tol = 2e-2 if dtype_name == "bfloat16" else 2e-5
    err = float((got.float() - want.float()).abs().max())
    ok = bool(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol))
    rows = sum(min(p, s - 1) + 1 for p in pos_list)     # rows this data needs
    esize = q.element_size()
    nbytes = 2 * q.numel() * esize + 2 * hkv * rows * hd * esize + 4 * b
    b_ms, b_by = bound(nbytes, 4.0 * hkv * g * hd * rows, dtype_name)
    q_lib = q.reshape(b, hkv * g, 1, hd)
    mask = (torch.arange(s, device="cuda")[None, :] <= pos[:, None])[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(q_lib, k, v, attn_mask=mask,
                                              enable_gqa=g > 1)
    return timed_record(
        torch, {"name": "decode_attention",
                "shape": f"q({b},{hkv},{g},{hd}) kv S={s} {layout} "
                         f"pos={pos_list} {dtype_name}",
                "splits": list(decode_attn.decode_splits(b, hkv, s,
                                                         build.sm_count(0))),
                "max_abs_err": err, "tol": tol, "ok": ok,
                "bound_ms": b_ms, "bound_by": b_by},
        kernel=lambda: decode_attn.decode_attention(q, k, v, pos),
        plain=lambda: decode_attn.decode_attention_plain(q, k, v, pos),
        library=library, iters=iters)


def phase_kernels(torch) -> dict[str, dict]:
    """Every case printed; returns each kernel's serve-path decode case."""
    d, f, e = 4096, 1376, 8
    cap_decode, cap_prefill = 2, 40      # capacity() at T = 4 and T = 128
    # C = 2560: capacity() at a real prefill, batch 4 x 2048 tokens.
    gmm_cases = [(e, c, kk, nn, "bfloat16")
                 for c in (cap_decode, cap_prefill, 2560)
                 for kk, nn in ((d, f), (f, d))]
    gmm_cases += [(e, cap_decode, d, f, "float32"), (e, cap_prefill, d, f, "float32"),
                  (3, 130, 100, 36, "bfloat16"), (3, 3, 100, 36, "float32")]
    last_pos = PROMPT + DECODE - 1       # the last decode step's positions
    s_serve = PROMPT + DECODE + 1
    long_pos = [2047, 1500, 1024, 17]
    attn_cases = [
        (BATCH, 32, 1, 128, s_serve, "bfloat16", [last_pos] * BATCH, "bhsd"),
        (BATCH, 32, 1, 128, 2048, "bfloat16", long_pos, "bhsd"),
        (BATCH, 32, 1, 128, 2048, "bfloat16", long_pos, "bshd"),
        (BATCH, 32, 1, 128, 2048, "bfloat16", [2047] * BATCH, "bhsd"),
        (2, 4, 3, 64, 333, "float32", [332, 100], "bhsd"),
    ]
    main = {}
    failed = []
    for case in gmm_cases:
        rec = check_gmm(torch, *case, iters=20)
        log("kernel " + json.dumps(rec))
        failed += [] if rec["ok"] else [rec["shape"]]
        if case == (e, cap_decode, d, f, "bfloat16"):
            main["gmm"] = rec
    for b, hkv, g, hd, s, dt, pos, layout in attn_cases:
        rec = check_decode(torch, b, hkv, g, s, hd, dt, pos, iters=50,
                           layout=layout)
        log("kernel " + json.dumps(rec))
        failed += [] if rec["ok"] else [rec["shape"]]
        if s == s_serve:
            main["decode_attention"] = rec
    if failed:
        raise SmokeFailure(f"kernel disagrees with its plain version: {failed}")
    return main


# --------------------------------------------------------------------- #
# Phase 4: small input, card (kernels) against CPU (plain versions)
# --------------------------------------------------------------------- #


def phase_small(torch) -> None:
    from repro_torch.configs import smoke_config
    from repro_torch.models import (decode_step, forward, init_params,
                                    prefill, random_batch)
    cfg = smoke_config(ARCH)                       # f32 compute
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def to_cuda(node):
        if isinstance(node, dict):
            return {k: to_cuda(v) for k, v in node.items()}
        if isinstance(node, list):
            return [to_cuda(v) for v in node]
        return node.to("cuda")

    results = {}
    for dev, p in (("cpu", params), ("cuda", to_cuda(params))):
        calib = random_batch(cfg, BATCH, 8, seed=7, device=dev)
        _, _, counts = forward(cfg, p, calib, return_router_stats=True)
        batch = random_batch(cfg, BATCH, 8, seed=0, device=dev)
        logits, cache = prefill(cfg, p, {"tokens": batch["tokens"]}, max_len=13)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        pos = torch.full((BATCH,), 8, dtype=torch.int32, device=dev)
        steps, toks = [logits], [tok]
        for _ in range(4):
            logits, cache = decode_step(cfg, p, cache, tok, pos)
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
            pos = pos + 1
            steps.append(logits)
            toks.append(tok)
        results[dev] = (counts.cpu(), torch.stack(steps).cpu(),
                        torch.cat(toks, 1).cpu())
    (c0, l0, t0), (c1, l1, t1) = results["cpu"], results["cuda"]
    err = float((l0 - l1).abs().max())
    log(f"small input ({cfg.name}, f32): card vs CPU logits max_abs_err="
        f"{err:.3g} (tol 2e-4), router counts equal={torch.equal(c0, c1)}, "
        f"greedy tokens equal={torch.equal(t0, t1)}")
    if not (err <= 2e-4 and torch.equal(c0, c1) and torch.equal(t0, t1)):
        raise SmokeFailure("serve path on the card disagrees with the CPU")


# --------------------------------------------------------------------- #
# Phase 5: full serve, launch counts
# --------------------------------------------------------------------- #


def phase_serve(torch, card: str) -> dict[str, int]:
    from repro_torch.configs import get_config
    from repro_torch.kernels import moe_gmm, ops
    from repro_torch.launch import serve
    cfg = get_config(ARCH)
    argv = ["--arch", ARCH, "--batch", str(BATCH), "--prompt-len",
            str(PROMPT), "--decode-tokens", str(DECODE)]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out, state = serve.run(argv)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log(f"serve {cfg.name} (d_model {cfg.d_model}, {cfg.n_layers} layers, "
        f"{cfg.n_experts} experts top-{cfg.top_k}, d_ff_expert "
        f"{cfg.d_ff_expert}): {out['tokens_per_s']:.2f} tok/s on {card}")
    log(f"placement cost: {json.dumps(out.get('dispatch_cost'))}")
    # A decode step reads every bf16 weight once: all experts (the buckets
    # cover every expert), the attention projections and the LM head.
    experts = cfg.n_layers * cfg.n_experts * 3 * cfg.d_model * cfg.d_ff_expert * 2
    attn = cfg.n_layers * (2 * cfg.d_model * cfg.q_dim
                           + 2 * cfg.d_model * cfg.kv_dim) * 2
    head = cfg.d_model * cfg.padded_vocab * 2
    step_ms = (experts + attn + head) / HBM_BYTES_PER_S * 1e3
    log(f"decode-step bound: {(experts + attn + head) / 1e9:.3f} GB of weights "
        f"(experts {experts / 1e9:.3f}, attention {attn / 1e9:.3f}, head "
        f"{head / 1e9:.3f}) -> {step_ms:.3f} ms at 3.35 TB/s -> "
        f"{BATCH / step_ms * 1e3:.0f} tok/s at batch {BATCH}; measured "
        f"{BATCH * 1e3 / out['tokens_per_s']:.3f} ms/step")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    logits, tokens = state["logits"], state["tokens"]
    finite = bool(torch.isfinite(logits).all())
    log(f"logits {tuple(logits.shape)} finite={finite}; tokens "
        f"{tuple(tokens.shape)}")
    if not finite or logits.shape != (BATCH, cfg.padded_vocab) \
            or tokens.shape != (BATCH, DECODE + 1) \
            or int(tokens.min()) < 0 or int(tokens.max()) >= cfg.padded_vocab:
        raise SmokeFailure("serve output has the wrong shape or values")
    # gmm: 3 per MoE layer per pass (calibrate, prefill, each decode step);
    # decode_attention: one per layer per decode step.
    want = {"gmm": 3 * cfg.n_layers * (2 + DECODE),
            "decode_attention": cfg.n_layers * DECODE}
    log(f"launch counts {json.dumps(counts)} (expected {json.dumps(want)})")
    if {k: counts[k] for k in want} != want:
        raise SmokeFailure(f"launch counts {counts} != expected {want}")
    paths = dict(moe_gmm.path_launches)
    log(f"gmm launches by path {json.dumps(paths)} (expected all "
        f"{want['gmm']} on wgmma)")
    if paths != {"wgmma": want["gmm"], "fma": 0}:
        raise SmokeFailure(f"gmm paths {paths}: not every serve launch ran "
                           "on the tensor cores")
    return counts


# --------------------------------------------------------------------- #
# Phase 6: where a decode step's time goes (torch.profiler)
# --------------------------------------------------------------------- #


def phase_profile(torch, n_steps: int = 4) -> None:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import (cast_for_compute, init_params, prefill,
                                    random_batch)
    cfg = get_config(ARCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = cast_for_compute(cfg, init_params(cfg, gen, "cuda"))
    batch = random_batch(cfg, BATCH, PROMPT, seed=0, device="cuda")
    logits, cache = prefill(cfg, params, {"tokens": batch["tokens"]},
                            max_len=PROMPT + DECODE + 1)
    step = make_serve_step(cfg)
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    pos = torch.full((BATCH,), PROMPT, dtype=torch.int32, device="cuda")
    for _ in range(2):                                     # warm
        tok, logits, cache = step(params, cache, tok, pos)
        pos = pos + 1
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            tok, logits, cache = step(params, cache, tok, pos)
            pos = pos + 1
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    kernels = device_times(prof, n_steps)
    busy_ms = sum(k[0] for k in kernels)
    log(f"profile: decode step {wall_ms:.3f} ms wall under the profiler, "
        f"device kernels {busy_ms:.3f} ms -> device busy "
        f"{busy_ms / wall_ms:.1%}, idle {1 - busy_ms / wall_ms:.1%} "
        f"({sum(k[1] for k in kernels):.0f} kernel launches per step)")
    for ms, calls, name in sorted(kernels, reverse=True)[:12]:
        log(f"profile:   {ms:8.3f} ms/step {calls:6.0f} calls/step  {name[:90]}")
    attn = [(ms, calls) for ms, calls, name in kernels
            if "decode_attn_kernel" in name]
    log(f"profile: decode_attention {sum(a[0] for a in attn):.4f} ms/step in "
        f"{sum(a[1] for a in attn):.0f} calls/step")


# --------------------------------------------------------------------- #
# Phase 7: the fleet simulator on the paper's world
# --------------------------------------------------------------------- #


def fleet_world():
    """The paper's constellation, llama-moe-3.5b's MoE shape, 3 plans and
    a 60 s trace at 2 requests/s (seeded); the constellation last."""
    import numpy as np

    from repro_torch import core
    from repro_torch.traffic import sample_requests
    t0 = time.perf_counter()
    con = core.Constellation(core.ConstellationConfig())
    topo = core.sample_topology(con, core.LinkConfig(),
                                np.random.default_rng(0))
    t_topo = time.perf_counter() - t0
    act = core.ActivationModel.zipf(32, 8, 2, seed=0)
    rng = np.random.default_rng(3)
    plans = [core.spacemoe_plan(con, topo, act),
             core.rand_intra_cg_plan(con.cfg, 32, 8, rng),
             core.rand_place_plan(con.cfg, 32, 8, rng)]
    req = sample_requests(np.random.default_rng(8), rate_rps=2.0,
                          horizon_s=60.0, n_stations=1)
    log(f"fleet world: {con.cfg.n_sats} satellites, {topo.n_slots} slots, "
        f"topology {t_topo:.1f}s, plans {time.perf_counter() - t0 - t_topo:.1f}s; "
        f"R={req.n_requests} requests, N={req.total_decode_tokens} decode "
        f"tokens")
    return topo, act, plans, req, con


def build_fleet(world, device, seed=5, qcfg=None, ground=None, req=None,
                **kw):
    """``FleetSim`` over ``world``; ``seed`` seeds the engine's expert
    draws, which set the unloaded horizon and so T.  ``qcfg``, ``ground``
    and ``req`` replace ``QueueConfig()``, no ground segment and the
    world's trace; ``kw`` (``batching``, ``probes``) go to ``FleetSim``."""
    import numpy as np

    from repro_torch import core
    from repro_torch.traffic import FleetSim, QueueConfig
    topo, act, plans, world_req = world[:4]
    t0 = time.perf_counter()
    sim = FleetSim(plans, topo, act, core.MoEWorkload.llama_moe_3p5b(),
                   core.ComputeConfig(), world_req if req is None else req,
                   np.random.default_rng(seed),
                   qcfg=QueueConfig() if qcfg is None else qcfg,
                   ground=ground, device=device, **kw)
    if device == "cuda":
        torch_sync()
    return sim, time.perf_counter() - t0


def torch_sync():
    import torch
    torch.cuda.synchronize()


def assert_parity(res_a, res_b, what, rtol=1e-5) -> int:
    """The reference's fused-vs-legacy criterion: identical served sets,
    goodput to 1e-9, TTFT/E2E per request and as quantiles to rtol; and
    each token's latency (queueing included, finite whether or not its
    request was served) to rtol.  Returns the requests served, summed
    over the plans."""
    import numpy as np
    for pa, pb in zip(res_a.plans, res_b.plans, strict=True):
        ok = np.array_equal(pa.served, pb.served) and np.isclose(
            pa.goodput_tok_s, pb.goodput_tok_s, rtol=1e-9, atol=0.0)
        for arr in ("ttft_s", "e2e_s", "token_total_s"):
            ok = ok and np.allclose(getattr(pa, arr), getattr(pb, arr),
                                    rtol=rtol, atol=0.0, equal_nan=True)
        for which in ("ttft", "e2e", "tpot"):
            for q in (0.5, 0.99):
                a, b = pa.quantile(which, q), pb.quantile(which, q)
                ok = ok and ((np.isnan(a) and np.isnan(b))
                             or bool(np.isclose(a, b, rtol=rtol)))
        if not ok:
            raise SmokeFailure(f"{what}: plan {pa.plan_name} differs")
    return sum(int(p.served.sum()) for p in res_a.plans)


def fleet_host_steps(torch, sim, res) -> dict[str, float]:
    """``FleetSim.run()`` (all requests active) step by step, as its
    ``_launch`` and ``run`` take them, each step timed on the host clock
    and ended in a synchronize (ms): ``chunk_table``, the iteration-1
    plane (``np.bincount``, per-row sums), the upload (f32 cast and
    host-to-device copies), the fused fixed point on the card, and the
    device-to-host copies with ``_finalize``.  The result must equal
    ``res``, a ``run()`` of ``sim``, bit for bit.  Under admission the
    targets' upload joins the upload; under batching the bincount step
    takes the three planes and ``law0`` is iteration 1's law on the
    host."""
    import numpy as np

    from repro_torch.traffic import batching, queueing
    t_bins, n_rows, dev = sim.n_bins, sim.n_rows, sim.device
    adm_on = sim.admission_on
    active = np.ones(sim.n_requests, dtype=bool)
    times: dict[str, float] = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        return out

    t_all = time.perf_counter()
    ct = step("chunk_table", lambda: sim.chunk_table(active[None, :]))

    def planes():
        out = [np.bincount(ct["flat0"], weights=ct[k],
                           minlength=n_rows * t_bins).reshape(
            1, n_rows, t_bins).astype(np.float64, copy=False)
            for k in ("work0", "wdec0", "cnt0") if k in ct]
        if sim._mig_rm is not None:
            out[0] += sim._mig_rm[None]
        return out, out[0].sum(axis=2)
    planes0, work0_sum = step("bincount", planes)
    plane0 = planes0[0]
    if sim.batching is not None:
        plane0 = step("law0", lambda: batching.effective_work_np(
            *planes0, sim._batch_table, sim._batch_cap,
            sim._batch_window)[0])

    def upload():
        chunks = {k: torch.from_numpy(ct[k]).to(dev)
                  for k in ("src", "offs", "work", "fprow", "row_ptr", "fpr",
                            "wdec", "cntw")
                  if k in ct}
        targets = sim._targets(1, None, None) if adm_on else ()
        batch = None if sim.batching is None else dict(
            table=torch.from_numpy(sim._batch_table).to(dev),
            bcap=sim._batch_cap, window=sim._batch_window)
        return (chunks, torch.from_numpy(plane0.astype(np.float32)).to(dev),
                torch.from_numpy(work0_sum).to(dev), targets, batch)
    chunks, work0, work0_sum, targets, batch = step("upload", upload)
    out = step("fixed_point", lambda: queueing._fleet_fixed_point(
        sim._device_tables(), chunks, work0, work0_sum,
        max(1, sim.qcfg.iterations), t_bins, n_rows, True, *targets,
        batch=batch))

    def finalize():
        host = {k: v.cpu().numpy()[0] for k, v in out.items() if k != "wait"}
        host["work_sum"] = sim._expand_rows(host["work_sum"])
        return sim._finalize(active, host, adm_on, None)
    again = step("finalize", finalize)
    times["total"] = (time.perf_counter() - t_all) * 1e3
    assert_parity(res, again, "run() itemized vs run()", rtol=0.0)
    if adm_on:
        same_admission(res, again, "run() itemized vs run()")
    return times


def phase_fleet(torch) -> tuple[dict, dict, dict, tuple]:
    """Returns (launch counts of run(), the kernels' captured inputs, their
    device ms per launch in the profiled run(), the world)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.traffic import queueing
    world = fleet_world()
    sim, t_build = build_fleet(world, "cuda")
    n_real = sim._f_req.size
    log(f"fleet FleetSim on the card: T={sim.n_bins} bins, "
        f"{sim.n_rows} compact rows, {n_real} chunks, built in "
        f"{t_build:.1f}s")
    for seed in (0, 13):               # T moves with the draws' seed
        other, _ = build_fleet(world, "cuda", seed=seed)
        log(f"fleet FleetSim with draw seed {seed}: T={other.n_bins} bins, "
            f"{other.n_rows} compact rows, {other._f_req.size} chunks")
        del other

    # Capture the inputs run() gives each kernel (the wrappers still count).
    captured: dict = {}
    real_deposit, real_scan = queueing.deposit, queueing.backlog_scan

    def deposit_rec(rows, cols, vals, n_rows, n_cols, row_ptr,
                    key="deposit"):
        captured.setdefault(key, (
            rows.clone(), cols.clone(), vals.clone(), n_rows, n_cols,
            row_ptr.clone()))
        return real_deposit(rows, cols, vals, n_rows, n_cols,
                            row_ptr=row_ptr)

    def scan_rec(work, cap, dt, key="backlog_scan"):
        captured.setdefault(key, (work.clone(), cap, dt))
        return real_scan(work, cap, dt)

    queueing.deposit, queueing.backlog_scan = deposit_rec, scan_rec
    try:
        ops.reset_launch_counts()
        res = sim.run()
        torch_sync()
        counts = ops.launch_counts()
    finally:
        queueing.deposit, queueing.backlog_scan = real_deposit, real_scan
    want = {"deposit": 2, "backlog_scan": 3}       # iterations=3: 2 + 3
    log(f"fleet run() launch counts {json.dumps(counts)} (expected "
        f"{json.dumps(want)} for iterations={sim.qcfg.iterations})")
    if {k: counts[k] for k in want} != want:
        raise SmokeFailure(f"fleet launch counts {counts} != {want}")

    walls = []
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    for _ in range(2):
        t0 = time.perf_counter()
        again = sim.run()
        torch_sync()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - mem0
    log(f"fleet run(): peak device memory {peak / 2**20:.1f} MiB above what "
        "it held before")
    assert_parity(res, again, "card run() vs card run()", rtol=0.0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run()
        torch_sync()
        prof_wall = time.perf_counter() - t0
    kernels = device_times(prof, 1)
    in_run, seen = {}, {}
    for name, cuda_names in FLEET_KERNELS.items():
        hits = [(ms, calls) for ms, calls, key in kernels
                if any(k in key for k in cuda_names)]
        seen[name] = sorted(calls for _, calls in hits)
        in_run[name] = sum(ms for ms, _ in hits) / want[name]
    if any(seen[n] != [want[n]] * len(FLEET_KERNELS[n]) for n in want):
        raise SmokeFailure(f"the profiled fleet run() recorded launches "
                           f"{seen} of {FLEET_KERNELS}, not {want} of each: "
                           "its busy share would be short")
    busy = sum(k[0] for k in kernels) / 1e3
    log(f"fleet run(): {min(walls) * 1e3:.1f} ms wall (best of 2, "
        f"synchronized); under the profiler {prof_wall * 1e3:.1f} ms wall, "
        f"device kernels {busy * 1e3:.1f} ms -> device busy "
        f"{busy / prof_wall:.1%}, idle {1 - busy / prof_wall:.1%} "
        f"({sum(k[1] for k in kernels):.0f} kernel launches)")
    for ms, calls, name in sorted(kernels, reverse=True)[:10]:
        log(f"fleet profile: {ms:9.3f} ms {calls:6.0f} calls  {name[:80]}")
    for _ in range(2):
        steps = fleet_host_steps(torch, sim, res)
        log(f"fleet run() itemized (host clock, each step ends in a "
            f"synchronize; ms): {json.dumps(steps)}")
    for p in res.plans:
        log(f"fleet plan {p.plan_name}: served {int(p.served.sum())}/"
            f"{int(p.active.sum())}, goodput {p.goodput_tok_s:.3f} tok/s, "
            f"TTFT p50 {p.quantile('ttft', 0.5):.3f} s p99 "
            f"{p.quantile('ttft', 0.99):.3f} s, E2E p99 "
            f"{p.quantile('e2e', 0.99):.3f} s")
        r = sim.n_requests
        ok = (p.served.shape == p.ttft_s.shape == p.e2e_s.shape == (r,)
              and np.isfinite(p.ttft_s[p.served]).all()
              and np.isnan(p.ttft_s[~p.served]).all()
              and (p.e2e_s[p.served] >= p.ttft_s[p.served]).all()
              and np.isfinite(p.token_total_s).all())
        if not ok:
            raise SmokeFailure(f"fleet plan {p.plan_name}: outputs of the "
                               "wrong shape or non-finite where served")

    # run_many over the bench_fleet thinning fractions.
    u = np.random.default_rng(1).random(sim.n_requests)
    masks = u[None, :] < np.asarray(FLEET_FRACTIONS)[:, None]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    many = sim.run_many(masks)
    torch_sync()
    t_many = time.perf_counter() - t0
    many_counts = ops.launch_counts()
    # One more, untimed call keeps run_many's first deposit and scan
    # inputs for phase 8.
    queueing.backlog_scan = lambda *a: scan_rec(*a, key="backlog_scan_many")
    queueing.deposit = lambda *a, row_ptr: deposit_rec(
        *a, row_ptr, key="deposit_many")
    try:
        sim.run_many(masks)
    finally:
        queueing.deposit, queueing.backlog_scan = real_deposit, real_scan
    log(f"fleet run_many over {len(FLEET_FRACTIONS)} fractions: "
        f"{t_many * 1e3:.1f} ms wall (synchronized), launch counts "
        f"{json.dumps(many_counts)}")
    if {k: many_counts[k] for k in want} != want:
        raise SmokeFailure(f"run_many launch counts {many_counts} != {want}")
    for frac, r in zip(FLEET_FRACTIONS, many):
        p = r.plans[0]
        log(f"fleet sweep {frac:.2f}: offered {p.offered_rps:.3f} rps, "
            f"served {sum(int(q.served.sum()) for q in r.plans)} over the "
            f"plans, {p.plan_name} goodput {p.goodput_tok_s:.3f} tok/s, "
            f"TTFT p99 {p.quantile('ttft', 0.99):.3f} s")
    assert_parity(many[-1], res, "run_many(fraction 1.0) vs run()",
                  rtol=1e-12)

    # The card against the CPU's plain versions: the full run() (in this
    # world every request overflows at the full rate, so there only the
    # per-token latencies carry numbers) and the two smallest fractions,
    # which must serve some.
    cpu_sim, t_cpu_build = build_fleet(world, "cpu")
    t0 = time.perf_counter()
    res_cpu = cpu_sim.run()
    t_cpu = time.perf_counter() - t0
    for what, got, want_res in [("run()", res, res_cpu)] + [
            (f"run_many row {FLEET_FRACTIONS[i]:.2f}", many[i],
             cpu_sim.run(active=masks[i])) for i in (0, 1)]:
        served = assert_parity(want_res, got, f"card {what} vs CPU")
        exact = all(
            np.array_equal(getattr(a, k), getattr(b, k), equal_nan=True)
            for a, b in zip(want_res.plans, got.plans)
            for k in ("ttft_s", "e2e_s", "token_total_s"))
        log(f"fleet card vs CPU {what}: parity holds, {served} requests "
            f"served over the plans on both, bitwise equal: {exact}")
        if what != "run()" and served == 0:
            raise SmokeFailure(f"fleet card vs CPU {what}: no request "
                               "served, the comparison would be empty")
    log(f"fleet CPU construction {t_cpu_build:.1f}s, CPU run() {t_cpu:.1f}s")
    return counts, captured, in_run, world


# --------------------------------------------------------------------- #
# Phase 8: the fleet kernels on the inputs run() gave them
# --------------------------------------------------------------------- #


def deposit_table_stats(torch, rows, cols, vals, n_rows, n_cols,
                        row_ptr) -> dict:
    """The shape of a deposit table that the kernel's time rests on:
    triples per row (median, max), per (row, tile) bucket (max; tiles of
    ``deposit.TILE`` bins), the most triples on one cell (the longest
    chain of dependent adds, also counting only the non-zero values the
    kernel adds), and the shares of zero-valued triples and of triples
    on the last bin (T - 1, where the fleet clamps times past its
    horizon)."""
    from repro_torch.kernels import deposit
    n = int(row_ptr[-1])
    r, c, v = rows[:n], cols[:n], vals[:n]
    per_row = (row_ptr[1:] - row_ptr[:-1]).float()
    tiles = deposit.deposit_tiles(n_cols)
    buckets = torch.bincount(r * tiles + c // deposit.TILE)
    flat = r * n_cols + c
    cells = torch.unique(flat, return_counts=True)[1]
    nonzero = torch.unique(flat[v != 0], return_counts=True)[1]
    return {"triples": n, "per_row_median": float(per_row.median()),
            "per_row_max": int(per_row.max()),
            "per_bucket_max": int(buckets.max()) if n else 0,
            "per_cell_max": int(cells.max()) if n else 0,
            "per_cell_max_nonzero": (int(nonzero.max())
                                     if nonzero.numel() else 0),
            "zero_share": float((v == 0).float().mean()) if n else 0.0,
            "last_bin_share": (float((c == n_cols - 1).float().mean())
                               if n else 0.0)}


def deposit_bound(n_real: int, n_rows: int, n_cols: int) -> tuple[float, str]:
    """What deposit must move: each real triple's bin and value (int64 +
    f64; rows are implied by row_ptr, the padding is not read), row_ptr,
    and the f64 plane written once; one add a triple."""
    nbytes = 16 * n_real + 8 * (n_rows + 1) + 8 * n_rows * n_cols
    return bound(nbytes, n_real, "float64")


def check_deposit(torch, table, what: str) -> dict:
    """deposit on a table the fleet passed it, against its plain version
    (bitwise), with its table's shape, its device time and the plain
    version's and the library call's, and the least time the card
    could take."""
    from repro_torch.kernels import deposit
    rows, cols, vals, n_rows, n_cols, row_ptr = table
    got = deposit.deposit(rows, cols, vals, n_rows, n_cols, row_ptr=row_ptr)
    torch.cuda.synchronize()
    want = deposit.deposit_plain(rows, cols, vals, n_rows, n_cols)
    same = bool(torch.equal(got, want))
    err = float((got - want).abs().max())
    del got, want
    n_real = int(row_ptr[-1])
    b_ms, b_by = deposit_bound(n_real, n_rows, n_cols)
    flat = rows * n_cols + cols

    def library():
        return torch.zeros(n_rows * n_cols, dtype=torch.float64,
                           device="cuda").index_put_((flat,), vals,
                                                     accumulate=True)
    return timed_record(
        torch, {"name": "deposit",
                "shape": f"{n_real} triples (+{rows.numel() - n_real} "
                         f"padding) into {n_rows} x {n_cols} f64, {what}",
                **deposit_table_stats(torch, rows, cols, vals, n_rows,
                                      n_cols, row_ptr),
                "scratch_bytes": deposit.scratch_bytes(rows.numel(), n_rows,
                                                       n_cols),
                "max_abs_err": err, "tol": 0.0, "ok": same,
                "bound_ms": b_ms, "bound_by": b_by},
        kernel=lambda: deposit.deposit(rows, cols, vals, n_rows, n_cols,
                                       row_ptr=row_ptr),
        plain=lambda: deposit.deposit_plain(rows, cols, vals, n_rows, n_cols),
        library=library, iters=5)


def phase_fleet_kernels(torch, captured, in_run) -> dict[str, dict]:
    """Each fleet kernel against its plain version on the inputs run()
    and run_many gave it.  ``in_run``: device ms per call inside the
    profiled run() (printed beside the kernel's own time)."""
    deps = [check_deposit(torch, captured.pop("deposit"), "run()"),
            check_deposit(torch, captured.pop("deposit_many"),
                          f"run_many over {len(FLEET_FRACTIONS)} fractions")]
    deps[0]["in_run_ms"] = in_run["deposit"]
    for dep in deps:
        log("kernel " + json.dumps(dep))

    work, cap, dt = captured["backlog_scan"]
    scans = [check_scan(torch, work, cap, dt, "run()")]
    scans[0]["in_run_ms"] = in_run["backlog_scan"]
    scans.append(check_scan(torch, *captured.pop("backlog_scan_many"),
                            f"run_many over {len(FLEET_FRACTIONS)} fractions"))
    scans.append(check_scan(torch, never_coalescing_plane(torch, work.shape,
                                                          cap, dt),
                            cap, dt, "built never to coalesce"))
    for rec in scans:
        log("kernel " + json.dumps(rec))
    bad = [rec["shape"] for rec in deps + scans if not rec["ok"]]
    if bad:
        raise SmokeFailure(f"fleet kernels disagree with their plain "
                           f"versions on {bad}")
    return {"deposit": deps[0], "backlog_scan": scans[0]}


def never_coalescing_plane(torch, shape, cap, dt, time_major=False):
    """A (T, C) work plane on which no chunk's two bracketing runs ever
    meet: half the cap in bin 0, then dt a bin, so every backlog sits at
    cap / 2 - dt, strictly inside (0, cap - dt); the run from 0 stays at
    0 and the run from cap - dt stays near it.  Laid out as the fleet
    passes its planes (a transposed view, bins contiguous), or
    ``time_major``."""
    t, c = shape
    work = torch.full((t, c) if time_major else (c, t), float(dt),
                      dtype=torch.float32, device="cuda")
    work = work if time_major else work.T
    work[0] = float(cap) / 2
    return work


def coalescence_stats(torch, coal, chunk: int, n_bins: int) -> dict:
    """From backlog_scan's coalescence report (chunks x columns): over the
    (column, chunk) pairs after the first chunk (which starts exactly),
    the share whose runs met, the mean bins to meeting over those, and
    the share of the plane's cells the fix-up re-reads (a warp re-runs
    the most bins any of its 32 columns needs), and the longest stretch
    of consecutive chunks in which one column never met (the fix-up runs
    those chunks one after another)."""
    from repro_torch.kernels.backlog_scan import TILE_COLS
    later = coal[1:].long()
    n_cols = coal.shape[1]
    if later.numel() == 0:
        return {"coalesced_share": None, "longest_serial_chunks": 0,
                "mean_bins_to_coalesce": None, "rerun_share": 0.0}
    met = later >= 0
    lengths = torch.full((later.shape[0], 1), chunk, device=coal.device)
    lengths[-1] = n_bins - chunk * later.shape[0]
    todo = torch.where(met, later, lengths)
    pad = -n_cols % TILE_COLS
    todo = torch.nn.functional.pad(todo, (0, pad)).reshape(
        later.shape[0], -1, TILE_COLS).amax(dim=2)
    live = torch.full((todo.shape[1],), TILE_COLS, device=coal.device)
    live[-1] -= pad                                    # columns a tile holds
    run = longest = torch.zeros(n_cols, dtype=torch.long, device=coal.device)
    for row in ~met:                  # consecutive chunks a column never met
        run = torch.where(row, run + 1, 0)
        longest = torch.maximum(longest, run)
    return {"coalesced_share": float(met.float().mean()),
            "longest_serial_chunks": int(longest.max()),
            "mean_bins_to_coalesce": (float(later[met].float().mean())
                                      if bool(met.any()) else None),
            "rerun_share": float((todo * live).sum()) / (n_bins * n_cols)}


def check_scan(torch, work, cap, dt, what: str) -> dict:
    """backlog_scan on ``work``, laid out as the fleet passed it (a
    transposed view of its (F, rows, T) plane), against its plain loop
    (bitwise), with its device time on that same tensor, the plain loop's
    wall time, its coalescence statistics and the least time the card
    could take."""
    from repro_torch.kernels import backlog_scan, build
    t_bins, n_cols = work.shape
    chunk = backlog_scan.scan_chunk(t_bins, n_cols, build.sm_count(0))
    coal = torch.empty((-(-t_bins // chunk), n_cols), dtype=torch.int32,
                       device="cuda")
    got = backlog_scan.backlog_scan(work, cap, dt, coalescence=coal)
    torch.cuda.synchronize()
    ms, wall_ms, hidden = time_ms(torch, lambda: backlog_scan.backlog_scan(
        work, cap, dt), iters=5)
    want = None

    def plain():
        nonlocal want
        want = backlog_scan.backlog_scan_plain(work.contiguous(), cap, dt)
    plain_ms = event_ms(torch, plain, iters=1, warm=False)
    b_ms, b_by = bound(8 * work.numel(), 4 * work.numel(), "float32")
    return {"name": "backlog_scan",
            "shape": f"({t_bins}, {n_cols}) f32, strides "
                     f"{tuple(work.stride())}, {what}",
            "chunk": chunk, **coalescence_stats(torch, coal, chunk, t_bins),
            "max_abs_err": float((got - want).abs().max()), "tol": 0.0,
            "ok": bool(torch.equal(got, want)), "bound_ms": b_ms,
            "bound_by": b_by, "ms": ms, "wall_ms": wall_ms, "hidden": hidden,
            "plain_ms": plain_ms, "plain_wall_ms": plain_ms,
            "plain_hidden": False, "library_ms": None,
            "library_wall_ms": None}


# --------------------------------------------------------------------- #
# Phase 9: the fleet with a ground segment and the admission controller
# --------------------------------------------------------------------- #


def same_admission(res_a, res_b, what) -> None:
    """Identical shed and retry sets, plan by plan."""
    import numpy as np
    for pa, pb in zip(res_a.plans, res_b.plans, strict=True):
        if not (np.array_equal(pa.shed, pb.shed)
                and np.array_equal(pa.retries, pb.retries)):
            raise SmokeFailure(f"{what}: plan {pa.plan_name} sheds or "
                               "retries differently")


def sm_clock_mhz() -> float:
    """The card's highest SM clock, MHz (nvidia-smi)."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {res.stderr.strip()}")
    return float(res.stdout.strip().splitlines()[0])


def ctrl_coalescence_stats(torch, coal, n_ctrl: int) -> dict:
    """From admission_ctrl's coalescence report (cells x chunks): over the
    (cell, chunk) pairs after the first chunk (which starts exactly), the
    share whose bracket runs met and the mean bins to meeting; the share
    of all (cell, control bin) steps run again after pass 1 (the bins
    before the meeting; a chunk that never met is run twice more, by the
    walk and by pass 2); and the longest stretch of consecutive chunks in
    one cell that never met (the walk runs those one after another)."""
    from repro_torch.kernels.admission_ctrl import ctrl_chunk
    chunk = ctrl_chunk(n_ctrl)
    live = -(-n_ctrl // chunk)
    later = coal[:, 1:live].long()
    lengths = [min(chunk, n_ctrl - j * chunk) for j in range(live)]
    if later.numel() == 0:
        return {"chunk": chunk, "coalesced_share": None,
                "mean_bins_to_coalesce": None, "rerun_share": 0.0,
                "longest_serial_chunks": 0}
    met = later >= 0
    n = torch.tensor(lengths[1:], device=coal.device)[None, :]
    redo = torch.where(met, later, 2 * n)
    run = longest = torch.zeros(coal.shape[0], dtype=torch.long,
                                device=coal.device)
    for col in (~met).T:
        run = torch.where(col, run + 1, 0)
        longest = torch.maximum(longest, run)
    return {"chunk": chunk, "coalesced_share": float(met.float().mean()),
            "mean_bins_to_coalesce": (float(later[met].float().mean())
                                      if bool(met.any()) else None),
            "rerun_share": float(redo.sum()) / (coal.shape[0] * n_ctrl),
            "longest_serial_chunks": int(longest.max())}


def check_ctrl(torch, win, args, kw, what: str) -> dict:
    """admission_ctrl on a window-maximum tensor, against its plain loop
    (bitwise), with its device time, the plain loop's wall time, its
    chunks' coalescence statistics, the byte/operation bound and the
    serial chain's bound."""
    from repro_torch.kernels import admission_ctrl
    n_ctrl, n_f, n_p = win.shape
    n_g = args[0].shape[-1]
    cells = n_f * n_p * n_g
    coal = torch.empty((cells, admission_ctrl.LANES), dtype=torch.int32,
                       device="cuda")
    got = admission_ctrl.admission_ctrl(win, *args, coalescence=coal, **kw)
    torch.cuda.synchronize()
    ms, wall_ms, hidden = time_ms(
        torch, lambda: admission_ctrl.admission_ctrl(win, *args, **kw),
        iters=20)
    want = None

    def plain():
        nonlocal want
        want = admission_ctrl.admission_ctrl_plain(win, *args, **kw)
    plain_ms = event_ms(torch, plain, iters=1, warm=False)
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    same = bool(torch.equal(nan_g, nan_w)) and bool(torch.equal(
        got[~nan_g].view(torch.int32), want[~nan_w].view(torch.int32)))
    nbytes = 4 * (win.numel() + got.numel() + sum(a.numel() for a in args)
                  + (n_p if kw["pid"] is not None else 0))
    # f32 operations a (cell, control bin) of this data needs: AIMD two
    # adds, two compares, one multiply or add and one max or min; PID the
    # two headrooms (add, subtract, divide each, where a target is
    # finite), their min, the clamped integral (3), delta (5) and the
    # clamped update (4).
    if kw["pid"] is None:
        per_step = 6
    else:
        finite = int(bool(torch.isfinite(args[3]).all())) \
            + int(bool(torch.isfinite(args[4]).all()))
        per_step = 3 * finite + 1 + 3 + 5 + 4
    b_ms, b_by = bound(nbytes, per_step * cells * n_ctrl, "float32")
    # The loop-carried chain of the plain loop's order: three dependent f32
    # operations a control bin (AIMD: multiply or add, max or min, select;
    # PID: add, max, min on both admit and the integral), about 4 cycles
    # each, over every control bin; a chunk of the kernel runs it over
    # ctrl_chunk(n_ctrl) bins.
    clock = sm_clock_mhz() * 1e3
    serial_ms = n_ctrl * 3 * 4 / clock
    return {"name": "admission_ctrl",
            "shape": f"win ({n_ctrl}, {n_f}, {n_p}) -> ({n_ctrl}, {n_f}, "
                     f"{n_p}, {n_g}) f32, "
                     f"{'AIMD' if kw['pid'] is None else 'PID'}, {what}",
            **ctrl_coalescence_stats(torch, coal, n_ctrl),
            "max_abs_err": float((got - want).abs().nan_to_num().max()),
            "tol": 0.0, "ok": same, "bound_ms": b_ms, "bound_by": b_by,
            "serial_bound_ms": serial_ms,
            "chunk_chain_ms": admission_ctrl.ctrl_chunk(n_ctrl) * 3 * 4
            / clock, "ms": ms, "wall_ms": wall_ms,
            "hidden": hidden, "plain_ms": plain_ms,
            "plain_wall_ms": plain_ms, "plain_hidden": False,
            "library_ms": None, "library_wall_ms": None}


def never_coalescing_windows(torch, n_ctrl, n_f, n_p, n_g, policy):
    """Window maxima and a cell on which no chunk's bracket runs ever meet.
    AIMD: admit0 = +inf and every window over the target, so the upper
    run stays at +inf (the true trajectory) while the lower one falls to
    admit_min.  PID: every window on the TTFT target (TPOT off), so err =
    0, the integral runs from -W and W never meet, and admit, which
    needs the integral, never starts.  The windows are k-contiguous, as
    admission_window returns them."""
    def full(shape, v):
        return torch.full(shape, v, dtype=torch.float32, device="cuda")
    kw = dict(increase=0.1, decrease=0.6, admit_min=0.05, pid=None)
    win = full((n_f, n_p, n_ctrl), 5.0 if policy == "aimd" else 3.0)
    win = win.permute(2, 0, 1)
    if policy == "aimd":
        admit0 = full((n_f, n_p, n_g), float("inf"))
    else:
        admit0 = full((n_f, n_p, n_g), 0.5)
        kw["pid"] = dict(kp=0.4, ki=0.05, kd=0.0, gain=full((n_p,), 1.0))
    return win, (full((n_p, n_g), 1.0), full((n_p,), 0.0), admit0,
                 full((n_f,), 4.0), full((n_f,), float("inf"))), kw


def window_bound(wait, work_last, tables, n_ctrl: int, seg) -> tuple:
    """The least time the card could take for admission_window: the wait
    plane, the last bin's work, the int32 station tables and the bins'
    slot and window read once, the maxima written once; f32 operations
    over the bins that belong to a window (the gateway sum, the expert
    maxima and their sum, and gateway + expert a (bin, f, p))."""
    n_bins, n_f, _ = wait.shape
    gw, ex = tables
    n_p, n_l = gw.shape[-2:]
    n_i = ex.shape[-1] // n_l
    nbytes = 4 * (wait.numel() + work_last.numel() + gw.numel() + ex.numel()
                  + 2 * n_bins + n_ctrl * n_f * n_p)
    bins = int((seg < n_ctrl).sum())
    ops = bins * n_f * n_p * ((n_l - 1) + n_l * (n_i - 1) + (n_l - 1) + 1)
    return bound(nbytes, ops, "float32")


def check_window(torch, args, what: str) -> dict:
    """admission_window on a wait trace the fleet gave it, against its
    plain version (bitwise), with its device time, the plain version's
    wall time and the least time the card could take."""
    from repro_torch.kernels import admission_window
    wait, work_last = args[0], args[1]
    seg, n_ctrl = args[7], args[8]
    got = admission_window.admission_window(*args)
    torch.cuda.synchronize()
    ms, wall_ms, hidden = time_ms(
        torch, lambda: admission_window.admission_window(*args), iters=20)
    want = None

    def plain():
        nonlocal want
        want = admission_window.admission_window_plain(*args)
    plain_ms = event_ms(torch, plain, iters=1, warm=False)
    b_ms, b_by = window_bound(wait, work_last, args[4:6], n_ctrl, seg)
    t, f, c = wait.shape
    n_p, n_l = args[4].shape[-2:]
    return {"name": "admission_window",
            "shape": f"wait ({t}, {f}, {c}) f32, stations "
                     f"{tuple(args[5].shape)} -> win ({n_ctrl}, {f}, "
                     f"{n_p}), {what}",
            "tile": admission_window.window_tile(
                f, c, n_p, n_l, args[5].shape[-1] // n_l,
                f if args[4].dim() == 4 else 1)[0],
            "max_abs_err": float((got - want).abs().max()), "tol": 0.0,
            "ok": bool(torch.equal(got, want)), "bound_ms": b_ms,
            "bound_by": b_by, "ms": ms, "wall_ms": wall_ms, "hidden": hidden,
            "plain_ms": plain_ms, "plain_wall_ms": plain_ms,
            "plain_hidden": False, "library_ms": None,
            "library_wall_ms": None}


def fleet_plan_lines(res, what: str) -> int:
    """Served, shed and retried requests per plan; returns the served
    total."""
    import numpy as np
    for p in res.plans:
        log(f"{what} plan {p.plan_name}: served {int(p.served.sum())}/"
            f"{int(p.active.sum())}, shed {int(p.shed.sum())}, admitted on "
            f"a retry {int((p.retries > 0).sum())}, goodput "
            f"{p.goodput_tok_s:.3f} tok/s, TTFT p50 "
            f"{p.quantile('ttft', 0.5):.3f} s p99 "
            f"{p.quantile('ttft', 0.99):.3f} s")
        ok = (p.served.shape == p.shed.shape == (p.active.size,)
              and not (p.served & p.shed).any()
              and np.isfinite(p.ttft_s[p.served]).all()
              and (p.e2e_s[p.served] >= p.ttft_s[p.served]).all()
              and np.isfinite(p.token_total_s).all())
        if not ok:
            raise SmokeFailure(f"{what} plan {p.plan_name}: outputs of the "
                               "wrong shape, served and shed, or non-finite")
    return sum(int(p.served.sum()) for p in res.plans)


def phase_fleet_admission(torch, world) -> tuple[dict, dict, dict, tuple]:
    """Returns (admission_window's and admission_ctrl's records on the AIMD
    run()'s last iteration, the launch counts of that run(), the AIMD
    simulators on the card and on the CPU)."""
    import copy

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import core
    from repro_torch.kernels import ops
    from repro_torch.traffic import (AdmissionConfig, QueueConfig, admission,
                                     build_ground_segment, queueing,
                                     sample_requests)
    _, _, _, _, con = world
    t0 = time.perf_counter()
    ground = build_ground_segment(con, core.LinkConfig(),
                                  min_elevation_deg=10.0)
    req = sample_requests(np.random.default_rng(8), rate_rps=2.0,
                          horizon_s=60.0, n_stations=ground.n_stations)
    log(f"admission world: {ground.n_stations} gateways (coverage "
        f"{ground.coverage():.3f}, ranked {ground.n_ranked} deep), built "
        f"{time.perf_counter() - t0:.1f}s; R={req.n_requests} requests, "
        f"N={req.total_decode_tokens} decode tokens")
    want = {"deposit": 2, "backlog_scan": 3, "admission_window": 3,
            "admission_ctrl": 3}
    captured: dict[str, list] = {}
    windows: dict[str, list] = {}
    tag = [None]
    real_ctrl, real_states = admission.admission_ctrl, queueing.controller_states
    real_window = admission.admission_window
    last_admit = []

    def ctrl_rec(win, *args, **kw):
        if tag[0] is not None:
            captured.setdefault(tag[0], []).append((win.clone(), args, kw))
        return real_ctrl(win, *args, **kw)

    def window_rec(*args):
        if tag[0] is not None:
            windows.setdefault(tag[0], []).append(
                tuple(a.clone() if torch.is_tensor(a) else a for a in args))
        return real_window(*args)

    def states_rec(*args, **kw):
        out = real_states(*args, **kw)
        last_admit[:] = [out[args[7]]]        # the trace: states[seg]
        return out
    admission.admission_ctrl, queueing.controller_states = ctrl_rec, states_rec
    admission.admission_window = window_rec
    sims, served = {}, 0
    try:
        for policy in ("aimd", "pid"):
            qcfg = QueueConfig(admission=AdmissionConfig(policy=policy))
            sim, t_build = build_fleet(world, "cuda", qcfg=qcfg,
                                       ground=ground, req=req)
            n_ctrl = int(sim._device_tables()["ctrl"].sum())
            twin = copy.copy(sim)
            t0 = time.perf_counter()
            twin._build_admission_tables(qcfg.admission, ground,
                                         sim.slots[:sim.n_requests],
                                         np.random.default_rng(0))
            t_tables = (time.perf_counter() - t0) * 1e3
            del twin
            log(f"{policy}: FleetSim on the card: T={sim.n_bins} bins, "
                f"SR={sim.n_rows} compact rows, n_ctrl={n_ctrl} control "
                f"bins, {sim._f_req.size} chunks, built in {t_build:.1f}s "
                f"(_build_admission_tables {t_tables:.1f} ms)")
            tag[0] = f"{policy} run()"
            ops.reset_launch_counts()
            res = sim.run()
            torch_sync()
            counts = ops.launch_counts()
            tag[0] = None
            log(f"{policy} run() launch counts {json.dumps(counts)} "
                f"(expected {json.dumps(want)})")
            if {k: counts[k] for k in want} != want:
                raise SmokeFailure(f"{policy} run() launch counts {counts} "
                                   f"!= {want}")
            if policy == "aimd":
                aimd_counts = counts
            walls = []
            for _ in range(2):
                t0 = time.perf_counter()
                again = sim.run()
                torch_sync()
                walls.append(time.perf_counter() - t0)
            assert_parity(res, again, f"{policy} card run() vs run()",
                          rtol=0.0)
            same_admission(res, again, f"{policy} card run() vs run()")
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                sim.run()
                torch_sync()
                prof_wall = time.perf_counter() - t0
            kernels = device_times(prof, 1)
            busy = sum(k[0] for k in kernels) / 1e3
            adm_k = {name: [(ms, calls) for ms, calls, key in kernels
                            if f"{name}_kernel" in key]
                     for name in ("admission_window", "admission_ctrl")}
            log(f"{policy} run(): {min(walls) * 1e3:.1f} ms wall (best of 2, "
                f"synchronized); under the profiler {prof_wall * 1e3:.1f} ms "
                f"wall, device kernels {busy * 1e3:.1f} ms -> device busy "
                f"{busy / prof_wall:.1%}, idle {1 - busy / prof_wall:.1%} "
                f"({sum(k[1] for k in kernels):.0f} kernel launches, against "
                f"the earlier gather-based controller's 1,203 launches and "
                f"47.4 ms with copies under AIMD; "
                + "; ".join(f"{name} {sum(c for _, c in v):.0f} launches, "
                            f"{sum(m for m, _ in v):.4f} ms"
                            for name, v in adm_k.items()) + ")")
            for ms, calls, name in sorted(kernels, reverse=True)[:10]:
                log(f"{policy} profile: {ms:9.3f} ms {calls:6.0f} calls  "
                    f"{name[:80]}")
            steps = fleet_host_steps(torch, sim, res)
            q = sim._device_tables()
            resolve_ms = event_ms(
                torch, lambda: queueing._resolve_attempts(q, last_admit[0]),
                iters=5)
            log(f"{policy} run() itemized (host clock, each step ends in a "
                f"synchronize; ms): {json.dumps(steps)}; "
                f"_build_admission_tables {t_tables:.1f} (construction); "
                f"attempt resolve {resolve_ms:.3f} a fixed-point iteration "
                f"(CUDA events)")
            served += fleet_plan_lines(res, f"{policy} run()")
            cpu_sim, t_cpu_build = build_fleet(world, "cpu", qcfg=qcfg,
                                               ground=ground, req=req)
            t0 = time.perf_counter()
            res_cpu = cpu_sim.run()
            t_cpu = time.perf_counter() - t0
            n = assert_parity(res_cpu, res, f"{policy} card run() vs CPU")
            same_admission(res_cpu, res, f"{policy} card run() vs CPU")
            log(f"{policy} card vs CPU run(): parity holds, identical shed "
                f"and retries, {n} requests served over the plans on both "
                f"(CPU construction {t_cpu_build:.1f}s, run() {t_cpu:.1f}s)")
            sims[policy] = (sim, cpu_sim)

        # A latency-target sweep under AIMD, as bench_admission runs it.
        sim, cpu_sim = sims["aimd"]
        base = sim.run(zero_load=True)
        p99 = max(p.quantile("ttft", 0.99) for p in base.plans)
        targets = np.asarray(ADM_TARGET_SCALES) * p99
        masks = np.ones((len(targets), sim.n_requests), dtype=bool)
        tag[0] = "aimd run_many"
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        many = sim.run_many(masks, ttft_targets=targets)
        torch_sync()
        t_many = time.perf_counter() - t0
        many_counts = ops.launch_counts()
        tag[0] = None
        log(f"aimd run_many over ttft_targets {np.round(targets, 3).tolist()}"
            f" s ({list(ADM_TARGET_SCALES)} x the zero-load p99 TTFT "
            f"{p99:.3f} s): {t_many * 1e3:.1f} ms wall (synchronized), "
            f"launch counts {json.dumps(many_counts)}")
        if {k: many_counts[k] for k in want} != want:
            raise SmokeFailure(f"run_many launch counts {many_counts} != "
                               f"{want}")
        t0 = time.perf_counter()
        many_cpu = cpu_sim.run_many(masks, ttft_targets=targets)
        t_cpu = time.perf_counter() - t0
        for target, r, r_cpu in zip(targets, many, many_cpu):
            served += fleet_plan_lines(r, f"aimd target {target:.3f} s")
            assert_parity(r_cpu, r, f"aimd run_many target {target:.3f} vs "
                          "CPU")
            same_admission(r_cpu, r, f"aimd run_many target {target:.3f} vs "
                           "CPU")
        log(f"aimd card vs CPU run_many: parity holds at every target, "
            f"identical shed and retries (CPU run_many {t_cpu:.1f}s)")
    finally:
        admission.admission_ctrl = real_ctrl
        admission.admission_window = real_window
        queueing.controller_states = real_states
    if served == 0:
        raise SmokeFailure("no request served under admission: the card vs "
                           "CPU comparisons would hold only failures")

    wins = []
    for what, calls in windows.items():
        for i, args in enumerate(calls):
            rec = check_window(torch, args, f"{what} iteration {i + 1}")
            log("kernel " + json.dumps(rec))
            wins.append(rec)
    windows.clear()
    recs = []
    for what, calls in captured.items():
        for i, (win, args, kw) in enumerate(calls):
            rec = check_ctrl(torch, win, args, kw,
                             f"{what} iteration {i + 1}")
            log("kernel " + json.dumps(rec))
            recs.append(rec)
    win, args, _ = captured["aimd run()"][0]
    for policy in ("aimd", "pid"):
        never = never_coalescing_windows(torch, *win.shape,
                                         args[0].shape[1], policy)
        rec = check_ctrl(torch, *never, f"{policy.upper()} built never to "
                         "coalesce")
        log("kernel " + json.dumps(rec))
        if rec["coalesced_share"] != 0.0:
            raise SmokeFailure(f"the {policy} window tensor built never to "
                               f"coalesce coalesced: {rec}")
        recs.append(rec)
    bad = [r["shape"] for r in wins + recs if not r["ok"]]
    if bad or len(recs) != 11 or len(wins) != 9:
        raise SmokeFailure(f"admission kernels disagree with their plain "
                           f"versions on {bad} (or missed a call: "
                           f"{len(wins)} of 9 windows, {len(recs)} of 11 "
                           "cells)")
    return wins[2], recs[2], aimd_counts, sims["aimd"]


# --------------------------------------------------------------------- #
# Phase 10: the fleet with continuous batching and the flight recorder
# --------------------------------------------------------------------- #

#: The probe channels ``ProbeRecord`` carries (None where not recorded).
PROBE_CHANNELS = ("bins", "backlog_s", "util_s", "drops_s", "batch_b",
                  "qhat_s", "win_s", "admit", "gw_wait_s", "ex_wait_s")


def same_results(res_a, res_b, what) -> None:
    """Bit for bit: served sets and every latency array, NaNs included."""
    import numpy as np
    for pa, pb in zip(res_a.plans, res_b.plans, strict=True):
        for k in ("served", "ttft_s", "e2e_s", "token_total_s"):
            if not np.array_equal(getattr(pa, k), getattr(pb, k),
                                  equal_nan=k != "served"):
                raise SmokeFailure(f"{what}: plan {pa.plan_name} {k} differs")


def best_wall_ms(fn, n: int = 2) -> tuple[float, object]:
    """(best host-clock ms of ``n`` synchronized calls, the last result)."""
    walls, out = [], None
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        torch_sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    return min(walls), out


def check_probes(torch, sim, cpu_sim, what: str) -> dict:
    """``FleetSim(probes=)`` on a card simulator and its CPU twin: a
    probes-off ``run()``, then probed ones, whose ``last_probes`` must be
    the CPU's on every channel, then probes off again, which must give the
    first result bit for bit; the flight log of the probed run exported
    and validated.  Returns the probe record's cost, measured in one more
    probed ``run()`` around its two steps, each ended in a synchronize:
    the channels' gathers on the card (``_probe_channels``) and the
    host's copies and unwrapping (``FleetSim._record_probes``); the
    probed and unprobed ``run()`` walls (best of 2 each, host clock), and
    the trace's event counts."""
    import numpy as np

    from repro_torch.obs import (ProbeConfig, build_flight_log, chrome_trace,
                                 count_events, validate_trace)
    from repro_torch.traffic import queueing
    off_ms, before = best_wall_ms(sim.run)
    sim.probes = cpu_sim.probes = ProbeConfig()
    steps = {"gather_ms": 0.0, "record_ms": 0.0}
    real_channels, real_record = queueing._probe_channels, sim._record_probes

    def timed_step(key, fn):
        def call(*args, **kw):
            torch_sync()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch_sync()
            steps[key] += (time.perf_counter() - t0) * 1e3
            return out
        return call
    try:
        on_ms, probed = best_wall_ms(sim.run)
        queueing._probe_channels = timed_step("gather_ms", real_channels)
        sim._record_probes = timed_step("record_ms", real_record)
        try:
            sim.run()
        finally:
            queueing._probe_channels = real_channels
            del sim._record_probes
        rec = sim.last_probes
        t0 = time.perf_counter()
        cpu_res = cpu_sim.run()
        t_cpu = time.perf_counter() - t0
        cpu_rec = cpu_sim.last_probes
    finally:
        sim.probes = cpu_sim.probes = None
    for name in PROBE_CHANNELS:
        a, b = getattr(rec, name), getattr(cpu_rec, name)
        if (a is None) != (b is None) or (a is not None
                                          and not np.array_equal(a, b)):
            raise SmokeFailure(f"{what}: probe channel {name} differs "
                               "between the card and the CPU")
    assert_parity(cpu_res, probed, f"{what} probed, card vs CPU")
    same_results(before, probed, f"{what}: probed vs unprobed run()")
    same_results(before, sim.run(), f"{what}: probes-off run() after a "
                 "probed one")
    log_ = build_flight_log(sim, probed, scenario=what)
    trace = chrome_trace(log_)
    problems = validate_trace(json.loads(json.dumps(trace)))
    if problems:
        raise SmokeFailure(f"{what}: the flight-log trace fails its "
                           f"schema: {problems[:5]}")
    events = {ph: count_events(trace, "", ph) for ph in ("X", "C", "i", "M")}
    out = {**steps, "run_ms": off_ms,
           "probed_run_ms": on_ms, "recorded_bins": rec.n_recorded,
           "stride": rec.stride, "channels": [n for n in PROBE_CHANNELS
                                              if getattr(rec, n) is not None],
           "trace_events": events, "served": len(log_.served()),
           "control_events": len(log_.events), "cpu_probed_run_s": t_cpu}
    if rec.batch_b is not None:
        out["batch_b_max"] = float(rec.batch_b.max())
        out["batch_b_mean_where_decode"] = float(
            rec.batch_b[rec.batch_b > 1.0].mean()) \
            if (rec.batch_b > 1.0).any() else 1.0
    log(f"{what} probes: " + json.dumps(out))
    return out


def batching_bench_world():
    """The world of the reference's ``benchmarks/bench_batching.py`` at its
    non-fast setting (``bench_traffic._world(False)``): 17 x 16
    satellites, 20 slots, 16 MoE layers, Zipf 8 experts top-2, the 8
    default gateways at 10 degrees, SpaceMoE and RandIntra-CG plans, 180 s
    at 4 requests/s of short prompts; the constellation and the ground
    segment last."""
    import numpy as np

    from repro_torch import core
    from repro_torch.traffic import build_ground_segment, sample_requests
    con = core.Constellation(core.ConstellationConfig.scaled(17, 16,
                                                             n_slots=20))
    link = core.LinkConfig()
    topo = core.sample_topology(con, link, np.random.default_rng(0))
    act = core.ActivationModel.zipf(16, 8, 2, seed=0)
    ground = build_ground_segment(con, link, min_elevation_deg=10.0)
    plans = [core.spacemoe_plan(con, topo, act),
             core.rand_intra_cg_plan(con.cfg, 16, 8, np.random.default_rng(3))]
    req = sample_requests(np.random.default_rng(29), rate_rps=4.0,
                          horizon_s=180.0, n_stations=ground.n_stations,
                          prompt_median=4, prompt_max=16, decode_mean=8,
                          decode_max=16)
    return topo, act, plans, req, con, ground


def frontier_row(regime: str, fraction: float, plan) -> dict:
    """One frontier point, as ``bench_batching._frontier_row`` reports it."""
    import numpy as np

    def rnd(x, d):
        return round(float(x), d) if np.isfinite(x) else None
    return {"regime": regime, "fraction": fraction, "plan": plan.plan_name,
            "offered_rps": rnd(plan.offered_rps, 4),
            "goodput_tok_s": rnd(plan.goodput_tok_s, 3),
            "ttft_p99_s": rnd(plan.quantile("ttft", 0.99), 3),
            "drop_rate": round(plan.drop_rate, 4)}


def phase_batching_bench(torch) -> dict:
    """The reference's batching frontier rebuilt with the port: FIFO and
    ``BatchingConfig(b_max=8)``, each one ``run_many`` over the thinning
    fractions on the card against the CPU; ``b_max=1`` bitwise FIFO; the
    best goodput of each regime at p99 TTFT <= 2.5 x the zero-load p99,
    batched above FIFO (the benchmark's own gate)."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.traffic import BatchingConfig, QueueConfig
    t0 = time.perf_counter()
    world = batching_bench_world()
    ground = world[5]
    qcfg = QueueConfig(dt_s=0.05, tail_s=60.0)
    req = world[3]
    log(f"batching bench world: {world[4].cfg.n_sats} satellites, "
        f"{world[0].n_slots} slots, R={req.n_requests} requests, "
        f"N={req.total_decode_tokens} decode tokens, built "
        f"{time.perf_counter() - t0:.1f}s")
    regimes = {"fifo": None, "batched": BatchingConfig(b_max=BATCH_B_MAX),
               "b_max=1": BatchingConfig(b_max=1)}
    sims = {name: build_fleet(world, "cuda", seed=23, qcfg=qcfg,
                              ground=ground, req=req, batching=cfg)[0]
            for name, cfg in regimes.items()}
    sim = sims["fifo"]
    log(f"batching bench FleetSim: T={sim.n_bins} bins, SR={sim.n_rows} "
        f"compact rows, {sim._f_req.size} chunks")
    base = sim.run(zero_load=True)
    ttft0_p99 = max(p.quantile("ttft", 0.99) for p in base.plans)
    ttft_bound = BATCH_TTFT_BOUND_SCALE * ttft0_p99
    u = np.random.default_rng(31).random(req.n_requests)
    fractions = np.asarray(BATCH_FRACTIONS)
    masks = u[None, :] < fractions[:, None]
    rows, many, out = [], {}, {}
    for name, sim in sims.items():
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        many[name] = sim.run_many(masks)
        torch_sync()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        want = {"deposit": 2 if regimes[name] is None else 6,
                "backlog_scan": 3}
        log(f"batching bench {name} run_many over {list(BATCH_FRACTIONS)}: "
            f"{wall * 1e3:.1f} ms wall (synchronized, first call), launch "
            f"counts {json.dumps(counts)}")
        if {k: counts[k] for k in want} != want:
            raise SmokeFailure(f"batching bench {name} launch counts "
                               f"{counts} != {want}")
        out[f"{name}_run_many_ms"] = wall * 1e3
    same = [same_results(a, b, f"b_max=1 vs FIFO fraction {f}")
            for f, a, b in zip(BATCH_FRACTIONS, many["fifo"], many["b_max=1"])]
    log(f"batching bench: b_max=1 bitwise FIFO at all {len(same)} fractions")
    for name in ("fifo", "batched"):
        cpu_sim, _ = build_fleet(world, "cpu", seed=23, qcfg=qcfg,
                                 ground=ground, req=req,
                                 batching=regimes[name])
        t0 = time.perf_counter()
        cpu_many = cpu_sim.run_many(masks)
        t_cpu = time.perf_counter() - t0
        exact = True
        for frac, r, r_cpu in zip(BATCH_FRACTIONS, many[name], cpu_many):
            assert_parity(r_cpu, r, f"batching bench {name} fraction {frac} "
                          "card vs CPU")
            try:
                same_results(r_cpu, r, "")
            except SmokeFailure:
                exact = False
            rows += [frontier_row(name, float(frac), p) for p in r.plans]
        log(f"batching bench {name}: card vs CPU parity holds at every "
            f"fraction, bitwise equal: {exact} (CPU run_many {t_cpu:.1f}s)")
        del cpu_sim
    for r in rows:
        log("batching frontier " + json.dumps(r))
    for name in ("fifo", "batched"):
        ok = [r for r in rows if r["regime"] == name
              and r["ttft_p99_s"] is not None and r["ttft_p99_s"] <= ttft_bound]
        out[f"best_goodput_{name}"] = max(
            (r["goodput_tok_s"] or 0.0 for r in ok), default=0.0)
    out.update(zero_load_ttft_p99_s=ttft0_p99, ttft_bound_s=ttft_bound,
               capacity_gain=(out["best_goodput_batched"]
                              / out["best_goodput_fifo"]
                              if out["best_goodput_fifo"] > 0 else None))
    log(f"batching bench: zero-load p99 TTFT {ttft0_p99:.3f} s, bound "
        f"{ttft_bound:.3f} s; best goodput within it: FIFO "
        f"{out['best_goodput_fifo']:.3f}, batched "
        f"{out['best_goodput_batched']:.3f} tok/s (gain "
        f"{out['capacity_gain']})")
    if not out["best_goodput_batched"] > out["best_goodput_fifo"]:
        raise SmokeFailure("batching bench: batched goodput does not beat "
                           "FIFO at the matched p99 TTFT bound")
    return out


def phase_fleet_batching(torch, world, adm_sims) -> None:
    """Phase 7's world under ``BatchingConfig(b_max=8)``: ``run()`` on the
    card (deposit 6, backlog_scan 3 launches), its wall and device time,
    busy share, peak memory, host steps and the law's device time; the
    deposit kernel bitwise on the decode-work and decode-visit tables the
    run gave it; the card against the CPU; then the flight recorder on it
    and on phase 9's AIMD ``run()``, and the reference's batching
    frontier (:func:`phase_batching_bench`)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import deposit as dep
    from repro_torch.kernels import ops
    from repro_torch.traffic import BatchingConfig, queueing
    cfg = BatchingConfig(b_max=BATCH_B_MAX)
    sim, t_build = build_fleet(world, "cuda", batching=cfg)
    log(f"batched FleetSim on the card: T={sim.n_bins} bins, {sim.n_rows} "
        f"compact rows, {sim._f_req.size} chunks, speedup table "
        f"{np.round(sim._batch_table, 4).tolist()}, built in {t_build:.1f}s")
    captured = []
    real_deposit = queueing.deposit

    def deposit_rec(rows, cols, vals, n_rows, n_cols, row_ptr):
        if len(captured) < 3:
            captured.append((rows.clone(), cols.clone(), vals.clone(), n_rows,
                             n_cols, row_ptr.clone()))
        return real_deposit(rows, cols, vals, n_rows, n_cols,
                            row_ptr=row_ptr)
    queueing.deposit = deposit_rec
    try:
        ops.reset_launch_counts()
        res = sim.run()
        torch_sync()
        counts = ops.launch_counts()
    finally:
        queueing.deposit = real_deposit
    want = {"deposit": 6, "backlog_scan": 3}
    log(f"batched run() launch counts {json.dumps(counts)} (expected "
        f"{json.dumps(want)})")
    if {k: counts[k] for k in want} != want:
        raise SmokeFailure(f"batched run() launch counts {counts} != {want}")
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    wall_ms, again = best_wall_ms(sim.run)
    peak = torch.cuda.max_memory_allocated() - mem0
    log(f"batched run(): peak device memory {peak / 2**20:.1f} MiB above what "
        "it held before")
    same_results(res, again, "batched card run() vs run()")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run()
        torch_sync()
        prof_wall = time.perf_counter() - t0
    kernels = device_times(prof, 1)
    busy = sum(k[0] for k in kernels) / 1e3
    per = {name: sum(ms for ms, _, key in kernels
                     if any(k in key for k in cuda_names))
           for name, cuda_names in FLEET_KERNELS.items()}
    log(f"batched run(): {wall_ms:.1f} ms wall (best of 2, synchronized); "
        f"under the profiler {prof_wall * 1e3:.1f} ms wall, device kernels "
        f"{busy * 1e3:.1f} ms -> device busy {busy / prof_wall:.1%}, idle "
        f"{1 - busy / prof_wall:.1%} ({sum(k[1] for k in kernels):.0f} "
        f"kernel launches); deposit {per['deposit']:.3f} ms over 6 calls, "
        f"backlog_scan {per['backlog_scan']:.3f} ms over 3")
    for ms, calls, name in sorted(kernels, reverse=True)[:10]:
        log(f"batched profile: {ms:9.3f} ms {calls:6.0f} calls  {name[:80]}")
    for _ in range(2):
        steps = fleet_host_steps(torch, sim, res)
        log(f"batched run() itemized (host clock, each step ends in a "
            f"synchronize; ms): {json.dumps(steps)}")

    # The law on iteration 2's three planes, as run() deposited them.
    planes = [dep.deposit(*t[:5], row_ptr=t[5]) for t in captured]
    batch = dict(table=torch.from_numpy(sim._batch_table).cuda(),
                 bcap=sim._batch_cap, window=sim._batch_window)
    law_ms, law_wall_ms, _ = time_ms(
        torch, lambda: queueing._effective_plane(*planes, batch), iters=3)
    torch_sync()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    queueing._effective_plane(*planes, batch)
    torch_sync()
    law_peak = torch.cuda.max_memory_allocated() - mem0
    cells = planes[0].numel()
    log(f"batching law: {law_ms:.3f} ms device ({law_wall_ms:.3f} wall) per "
        f"iteration on {tuple(planes[0].shape)} f64 planes, "
        f"{-(-cells // queueing.LAW_BLOCK_CELLS)} row blocks; peak "
        f"{law_peak / 2**20:.1f} MiB above its three input planes "
        f"({3 * cells * 8 / 2**20:.1f} MiB); bound (3 f64 reads, one f32 "
        f"write) {bound(28 * cells, 0, 'float64')[0]:.4f} ms")
    del planes
    deps = [check_deposit(torch, captured[i], f"batched run() {what}")
            for i, what in ((1, "wdec"), (2, "cnt"))]
    del captured
    for d in deps:
        log("kernel " + json.dumps(d))
    if not all(d["ok"] for d in deps):
        raise SmokeFailure("deposit disagrees with its plain version on the "
                           "batching tables")

    cpu_sim, t_cpu_build = build_fleet(world, "cpu", batching=cfg)
    t0 = time.perf_counter()
    res_cpu = cpu_sim.run()
    t_cpu = time.perf_counter() - t0
    served = assert_parity(res_cpu, res, "batched card run() vs CPU")
    try:
        same_results(res_cpu, res, "")
        exact = True
    except SmokeFailure:
        exact = False
    log(f"batched card vs CPU run(): parity holds, {served} requests served "
        f"over the plans on both, bitwise equal: {exact} (CPU construction "
        f"{t_cpu_build:.1f}s, run() {t_cpu:.1f}s)")
    for p in res.plans:
        log(f"batched plan {p.plan_name}: served {int(p.served.sum())}/"
            f"{int(p.active.sum())}, TTFT p50 {p.quantile('ttft', 0.5):.3f} s"
            f" p99 {p.quantile('ttft', 0.99):.3f} s")
    check_probes(torch, sim, cpu_sim, "batched run()")
    del sim, cpu_sim
    check_probes(torch, *adm_sims, "AIMD run()")
    phase_batching_bench(torch)


# --------------------------------------------------------------------- #
# Phase 11: re-placement and the joint control plane
# --------------------------------------------------------------------- #

#: Phase 11 (a): the paper's world under backlog re-placement.
REPLAN_CADENCES = (1, 2, 3)
#: Phase 11 (b): the reference's benchmarks/bench_ctrl.py grid, cadence-major.
CTRL_CADENCES = (1, 2, 3)
CTRL_MIG_WEIGHTS = (0.0, 0.01, 0.1)
CTRL_TTFT_TARGETS = (30.0, 60.0, 90.0)


def same_decisions(a, b, what) -> None:
    """Identical decision trajectories of two ``ReplanOutcome``s (the
    reference bench's ``_compare_cell``): slot plans, boundaries, slots,
    chosen, switched, scores and migration bytes, bit for bit."""
    import numpy as np
    ra, rb = a.report, b.report
    problems = []
    if not np.array_equal(ra.schedule.slot_plan, rb.schedule.slot_plan):
        problems.append(f"slot plans {ra.schedule.slot_plan.tolist()} vs "
                        f"{rb.schedule.slot_plan.tolist()}")
    if len(ra.decisions) != len(rb.decisions):
        problems.append(f"{len(ra.decisions)} vs {len(rb.decisions)} "
                        "decisions")
    for da, db in zip(ra.decisions, rb.decisions):
        if (da.boundary, da.slot, da.chosen, da.switched) != \
                (db.boundary, db.slot, db.chosen, db.switched) \
                or not np.array_equal(da.scores, db.scores) \
                or da.migration_bytes != db.migration_bytes:
            problems.append(f"k={da.boundary}: {(da.chosen, da.switched)} "
                            f"vs {(db.chosen, db.switched)}, scores "
                            f"{da.scores.tolist()} vs {db.scores.tolist()}")
    if problems:
        raise SmokeFailure(f"{what}: decisions differ: {problems[:3]}")


def grid_stages(torch, call, profiled=False) -> tuple[dict, list, object]:
    """One controller-grid call through ``run_replan_grid``'s stage hook:
    per stage, host-clock ms with a synchronize at each boundary; or with
    ``profiled``, under ``torch.profiler`` with each stage a
    ``record_function`` range, the device time of the kernels each stage
    launched and the copies it made (ms; ``busy`` their sum, ``wall`` the
    call's, ``launches`` the device events).  Returns (ms per stage, summed over rounds; the
    profiled kernels as ``device_times`` gives them, or []; the
    outcomes)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    times: dict[str, float] = {}
    if not profiled:
        last = [0.0]

        def stage(name):
            torch.cuda.synchronize()
            now = time.perf_counter()
            times[name] = times.get(name, 0.0) + (now - last[0]) * 1e3
            last[0] = now
        torch.cuda.synchronize()
        last[0] = time.perf_counter()
        return times, [], call(stage)
    names: list[str] = []
    rng: list = []

    def stage(name):
        rng[0].__exit__(None, None, None)
        names.append(name)
        rng[0] = record_function(f"replan_stage_{len(names)}")
        rng[0].__enter__()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rng.append(record_function("replan_stage_0"))
        rng[0].__enter__()
        out = call(stage)
        rng[0].__exit__(None, None, None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # The profiler puts each range on the device's timeline too (from its
    # first kernel to its last): a device event inside a stage's span is
    # that stage's.
    from torch.autograd import DeviceType
    spans, device = [], []
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        if evt.name.startswith("replan_stage_"):
            k = int(evt.name.rsplit("_", 1)[1])
            spans.append((evt.time_range.start, evt.time_range.end,
                          names[k] if k < len(names) else "after"))
        else:
            device.append(evt)
    for evt in device:
        t = evt.time_range.start
        name = next((n for lo, hi, n in spans if lo <= t <= hi), "between")
        times[name] = times.get(name, 0.0) \
            + evt.time_range.elapsed_us() / 1e3
    kernels = [k for k in device_times(prof, 1)
               if not k[2].startswith("replan_stage_")]
    times["busy"] = sum(k[0] for k in kernels)
    times["wall"] = wall * 1e3
    times["launches"] = sum(k[1] for k in kernels)
    return times, kernels, out


def replan_paper(torch, world) -> dict:
    """Phase 11 (a): phase 7's world, FIFO, backlog re-placement over
    cadences 1, 2 and 3 in one ``run_many(replan=)``."""
    import dataclasses

    import numpy as np

    from repro_torch import core
    from repro_torch.kernels import ops
    from repro_torch.traffic import (QueueConfig, ReplanConfig, queueing,
                                     replan_base_scores, replan_traffic)
    topo, act, plans, req, _ = world
    wl, comp = core.MoEWorkload.llama_moe_3p5b(), core.ComputeConfig()
    qcfg = QueueConfig()
    rcfg = ReplanConfig(mode="backlog", controller_iterations=2,
                        hysteresis=0.0)
    # replan_traffic's seed discipline: one draw seeds the fleet, the
    # next integer seeds the base scores' draws.
    seed = int(np.random.default_rng(4).integers(0, 2**31 - 1))
    sim, t_build = build_fleet(world, "cuda", seed=seed, qcfg=qcfg)
    t0 = time.perf_counter()
    scores = replan_base_scores(plans, topo, act, wl, comp,
                                np.random.default_rng(seed + 1), rcfg,
                                device="cuda")
    t_scores = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim._ctrl_tables()
    t_tables = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim._ctrl_device()
    torch_sync()
    t_upload = time.perf_counter() - t0
    ct = sim._ctrl_tables()
    F = len(REPLAN_CADENCES)
    log(f"replan (a) paper world: T={sim.n_bins} bins, {sim.n_rows} probe "
        f"rows, {ct['n_rows_sched']} schedule rows, {ct['n_bounds'] + 1} "
        f"decision boundaries, {ct['ch_work'].size} gated chunks an entry "
        f"(F={F}: {F * ct['ch_work'].size} triples), built {t_build:.1f}s; "
        f"replan_base_scores ({topo.n_slots} slots of evaluate_plans) "
        f"{t_scores:.2f}s, _ctrl_tables {t_tables:.2f}s, upload "
        f"{t_upload:.2f}s")

    def grid(stage=None):
        return sim.run_many(replan=rcfg, base_scores=scores,
                            cadences=REPLAN_CADENCES) if stage is None \
            else sim.run_replan_grid(rcfg, base_scores=scores,
                                     cadences=REPLAN_CADENCES, stage=stage)
    captured = []
    real_deposit = queueing.deposit

    def deposit_rec(rows, cols, vals, n_rows, n_cols, row_ptr):
        if n_rows == F * ct["n_rows_sched"] and not captured:
            captured.append((rows.clone(), cols.clone(), vals.clone(),
                             n_rows, n_cols, row_ptr.clone()))
        return real_deposit(rows, cols, vals, n_rows, n_cols,
                            row_ptr=row_ptr)
    queueing.deposit = deposit_rec
    try:
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        fused = grid()
        torch_sync()
        t_first = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() - base_mem
    finally:
        queueing.deposit = real_deposit
    n, rounds = qcfg.iterations, rcfg.controller_iterations
    want = {"deposit": (n - 1) + rounds * n, "backlog_scan": n + rounds * n,
            "admission_window": 0, "admission_ctrl": 0}
    log(f"replan (a) run_many(replan=) over cadences {REPLAN_CADENCES}: "
        f"{t_first:.2f}s wall (first call), launch counts "
        f"{json.dumps(counts)} (expected {json.dumps(want)}: the probe's "
        f"{n} iterations, then per round an iteration-1 deposit on the "
        f"card and {n} iterations); peak device memory above the "
        f"simulator's {peak / 2**30:.2f} GiB")
    if {k: counts[k] for k in want} != want:
        raise SmokeFailure(f"replan (a) launch counts {counts} != {want}")
    host_ms, _, again = grid_stages(torch, grid)
    dev_ms, kernels, _ = grid_stages(torch, grid, profiled=True)
    for a, b in zip(fused, again):
        same_decisions(a, b, "replan (a) grid vs grid")
        assert_parity(a.result, b.result, "replan (a) grid vs grid",
                      rtol=0.0)
    log(f"replan (a) itemized, host clock with a synchronize at each "
        f"stage (ms): {json.dumps({k: round(v, 2) for k, v in host_ms.items()})}"
        f"; under the profiler, device time of each stage's kernels (ms): "
        f"{json.dumps({k: round(v, 3) for k, v in dev_ms.items()})} -> "
        f"device busy {dev_ms['busy'] / dev_ms['wall']:.1%} of the wall")
    for ms, calls, name in sorted(kernels, reverse=True)[:8]:
        log(f"replan (a) profile: {ms:9.3f} ms {calls:6.0f} calls  "
            f"{name[:80]}")

    # The host loop on the card, cadence by cadence: its decisions must be
    # the grid's bit for bit, its results the grid's at the fused-vs-
    # legacy criterion.
    t_host = 0.0
    for cad, out in zip(REPLAN_CADENCES, fused):
        t0 = time.perf_counter()
        host = replan_traffic(plans, topo, act, wl, comp, req,
                              np.random.default_rng(4),
                              dataclasses.replace(rcfg, period_slots=cad),
                              qcfg, device="cuda")
        torch_sync()
        t_host += time.perf_counter() - t0
        same_decisions(host, out, f"replan (a) cadence {cad}: host loop vs "
                       "grid")
        n_served = assert_parity(host.result, out.result,
                                 f"replan (a) cadence {cad}: host loop vs "
                                 "grid")
        rep = out.report
        log(f"replan (a) cadence {cad}: slot plan "
            f"{np.bincount(rep.schedule.slot_plan, minlength=len(plans)).tolist()}"
            f" slots per plan, {len(rep.decisions)} decisions, "
            f"{rep.n_switches} switches, {rep.total_migration_bytes:.0f} "
            f"bytes moved; host loop equal bit for bit; {n_served} requests "
            f"served over the {len(out.result.plans)} rows")
    log(f"replan (a) host loop over the 3 cadences {t_host:.1f}s vs the "
        f"grid's {t_first:.2f}s (first call)")
    dep = check_deposit(torch, captured.pop(), f"the schedule row's gated "
                        f"table (F={F}), iteration 1")
    log("kernel " + json.dumps(dep))
    if not dep["ok"]:
        raise SmokeFailure("deposit disagrees with its plain version on the "
                           "gated table")
    return dict(deposit=dep, host_ms=host_ms, dev_ms=dev_ms)


def ctrl_world(device):
    """``benchmarks/bench_ctrl.py``'s world at its non-fast setting: 8 x 12
    satellites, 10 slots, Zipf 4 experts top-2 over 4 layers, 3 plans,
    40 requests/s for 120 s over 2 gateways, AIMD at a 60 s TTFT target,
    6 s buffers, 10 s slots; the simulator seeded as replan_traffic seeds
    it, and the base scores."""
    import numpy as np

    from repro_torch import core
    from repro_torch.traffic import (AdmissionConfig, FleetSim, QueueConfig,
                                     ReplanConfig, replan_base_scores,
                                     sample_requests)
    con = core.Constellation(core.ConstellationConfig.scaled(
        8, 12, n_slots=10, survival_prob=1.0))
    topo = core.sample_topology(con, core.LinkConfig(),
                                np.random.default_rng(0))
    act = core.ActivationModel.zipf(4, 4, 2, seed=1)
    plans = [core.rand_intra_cg_plan(con.cfg, 4, 4, np.random.default_rng(7)),
             core.spacemoe_plan(con, topo, act),
             core.rand_intra_cg_plan(con.cfg, 4, 4,
                                     np.random.default_rng(11))]
    req = sample_requests(np.random.default_rng(2), rate_rps=40.0,
                          horizon_s=120.0, n_stations=2, prompt_median=8,
                          prompt_max=32, decode_mean=8, decode_max=16)
    qcfg = QueueConfig(dt_s=0.05, tail_s=30.0, slot_period_s=10.0,
                       buffer_s=6.0,
                       admission=AdmissionConfig(policy="aimd",
                                                 ttft_target_s=60.0))
    rcfg = ReplanConfig(mode="backlog", controller_iterations=1,
                        bytes_per_expert=qcfg.migration_bytes_per_expert)
    seed = int(np.random.default_rng(4).integers(0, 2**31 - 1))
    wl, comp = core.MoEWorkload.llama_moe_3p5b(), core.ComputeConfig()
    sim = FleetSim(plans, topo, act, wl, comp, req,
                   np.random.default_rng(seed), qcfg=qcfg, device=device)
    scores = replan_base_scores(plans, topo, act, wl, comp,
                                np.random.default_rng(seed + 1), rcfg,
                                device=device)
    return sim, scores, rcfg, (plans, topo, act, wl, comp, req, qcfg)


def replan_bench_grid(torch) -> dict:
    """Phase 11 (b): the reference bench's 27-cell grid in one
    ``run_replan_grid`` on the card, against the CPU and against the host
    loop cell by cell; the admission kernels on the per-entry tables it
    gave them.  (c): one cell's flight log with ``replan=``."""
    import dataclasses

    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.obs import (build_flight_log, chrome_trace,
                                 count_events, validate_trace)
    from repro_torch.traffic import admission, replan_traffic
    t0 = time.perf_counter()
    sim, scores, rcfg, (plans, topo, act, wl, comp, req, qcfg) = \
        ctrl_world("cuda")
    torch_sync()
    grid = dict(base_scores=scores, cadences=list(CTRL_CADENCES),
                mig_weights=list(CTRL_MIG_WEIGHTS),
                ttft_targets=list(CTRL_TTFT_TARGETS))
    F = len(CTRL_CADENCES) * len(CTRL_MIG_WEIGHTS) * len(CTRL_TTFT_TARGETS)
    log(f"replan (b) bench_ctrl world: R={sim.n_requests} requests, "
        f"T={sim.n_bins} bins, {sim.n_rows} probe rows, built with its base "
        f"scores in {time.perf_counter() - t0:.1f}s; {F} cells")
    windows, cells = [], []
    real_window, real_ctrl = admission.admission_window, admission.admission_ctrl

    def window_rec(*args):
        if args[4].dim() == 4:                       # per-entry tables
            windows.append(tuple(a.clone() if torch.is_tensor(a) else a
                                 for a in args))
        return real_window(*args)

    def ctrl_rec(win, *args, **kw):
        if args[0].dim() == 3:                       # per-entry anchors
            cells.append((win.clone(), args, kw))
        return real_ctrl(win, *args, **kw)
    admission.admission_window, admission.admission_ctrl = window_rec, ctrl_rec
    try:
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        fused = sim.run_replan_grid(rcfg, **grid)
        torch_sync()
        t_first = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() - base_mem
    finally:
        admission.admission_window, admission.admission_ctrl = \
            real_window, real_ctrl
    n = qcfg.iterations
    want = {"deposit": (n - 1) + n, "backlog_scan": 2 * n,
            "admission_window": 2 * n, "admission_ctrl": 2 * n}
    t0 = time.perf_counter()
    again = sim.run_replan_grid(rcfg, **grid)
    torch_sync()
    t_steady = time.perf_counter() - t0
    log(f"replan (b) run_replan_grid: {t_first:.2f}s wall (first call), "
        f"{t_steady:.2f}s (second); launch counts {json.dumps(counts)} "
        f"(expected {json.dumps(want)}); peak device memory above the "
        f"simulator's {peak / 2**30:.2f} GiB")
    if {k: counts[k] for k in want} != want:
        raise SmokeFailure(f"replan (b) launch counts {counts} != {want}")
    if len(windows) != n or len(cells) != n:
        raise SmokeFailure(f"replan (b): {len(windows)} admission_window and "
                           f"{len(cells)} admission_ctrl calls on per-entry "
                           f"tables, expected {n} each")
    for a, b in zip(fused, again):
        same_decisions(a, b, "replan (b) grid vs grid")

    cpu_sim, cpu_scores, _, _ = ctrl_world("cpu")
    if not np.array_equal(cpu_scores, scores):
        raise SmokeFailure("replan (b): base scores differ card vs CPU")
    t0 = time.perf_counter()
    cpu = cpu_sim.run_replan_grid(rcfg, **dict(grid, base_scores=cpu_scores))
    t_cpu = time.perf_counter() - t0
    served = 0
    for f, (a, b) in enumerate(zip(cpu, fused)):
        same_decisions(a, b, f"replan (b) cell {f}: card vs CPU")
        served += assert_parity(a.result, b.result,
                                f"replan (b) cell {f}: card vs CPU")
        same_admission(a.result, b.result, f"replan (b) cell {f}: card vs CPU")
    log(f"replan (b) card vs CPU: decisions bit for bit, identical served, "
        f"shed and retry sets, latencies at the fused-vs-legacy criterion "
        f"on all {F} cells ({served} requests served over the cells' rows; "
        f"CPU grid {t_cpu:.1f}s)")

    t0 = time.perf_counter()
    cells_cfg = [(c, w, tt) for c in CTRL_CADENCES for w in CTRL_MIG_WEIGHTS
                 for tt in CTRL_TTFT_TARGETS]
    switches = 0
    for f, ((cad, w, tt), out) in enumerate(zip(cells_cfg, fused)):
        qc = dataclasses.replace(qcfg, admission=dataclasses.replace(
            qcfg.admission, ttft_target_s=tt))
        rc = dataclasses.replace(rcfg, period_slots=cad,
                                 migration_weight_s_per_mb=w,
                                 bytes_per_expert=None)
        host = replan_traffic(plans, topo, act, wl, comp, req,
                              np.random.default_rng(4), rc, qc,
                              device="cuda")
        same_decisions(host, out, f"replan (b) cell {f} {(cad, w, tt)}: "
                       "host loop vs grid")
        switches += out.report.n_switches
    torch_sync()
    t_host = time.perf_counter() - t0
    log(f"replan (b) host loop, cell by cell on the card: {t_host:.1f}s for "
        f"{F} cells, decisions equal to the grid's bit for bit on all; the "
        f"one-call grid {t_steady:.2f}s: {t_host / t_steady:.1f}x "
        f"(reported, not gated); {switches} switches over the cells")
    if switches == 0:
        raise SmokeFailure("replan (b): no cell switched plans")

    wins = [check_window(torch, args, f"bench_ctrl grid's schedule row "
                         f"(F={F}, per-entry station maps), iteration "
                         f"{i + 1}") for i, args in enumerate(windows)]
    recs = [check_ctrl(torch, win, args, kw, f"bench_ctrl grid's schedule "
                       f"row (F={F}, per-entry anchors), iteration {i + 1}")
            for i, (win, args, kw) in enumerate(cells)]
    for rec in wins + recs:
        log("kernel " + json.dumps(rec))
    bad = [r["shape"] for r in wins + recs if not r["ok"]]
    if bad:
        raise SmokeFailure(f"admission kernels disagree with their plain "
                           f"versions on the per-entry tables: {bad}")

    # (c) one cell's flight log, its decisions as trace instants.
    out = fused[0]
    flight = build_flight_log(out.sim, out.result, replan=out.report,
                              scenario="bench_ctrl cell 0")
    trace = chrome_trace(flight)
    problems = validate_trace(json.loads(json.dumps(trace)))
    n_dec = len(out.report.decisions)
    got = {k: count_events(trace, k, "i") for k in ("replan", "joint")}
    log(f"replan (c) flight log of cell 0 with replan=: "
        f"{len(flight.requests)} request records, "
        f"{count_events(trace, '', 'X')} spans, instants {json.dumps(got)} "
        f"for {n_dec} decisions; validate_trace: "
        f"{problems[:3] if problems else 'no problems'}")
    if problems or got != {"replan": n_dec, "joint": n_dec}:
        raise SmokeFailure(f"replan (c): flight-log trace {problems[:3]}, "
                           f"instants {got} for {n_dec} decisions")
    return dict(window=wins[-1], ctrl=recs[-1])


def phase_replan(torch, world) -> dict:
    """Phase 11: re-placement and the joint control plane, (a) on the
    paper's world at full width, (b) on the reference bench's controller
    grid, (c) the flight log."""
    out = replan_paper(torch, world)
    out.update(replan_bench_grid(torch))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: this smoke "
                           "run needs a CUDA card")
    try:
        from repro_torch.kernels import build
    except ImportError as exc:
        raise SmokeFailure(f"cannot import the port from {ROOT / 'src'}: "
                           f"{exc}") from exc
    torch.backends.cuda.matmul.allow_tf32 = False    # plain f32 is exact f32
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__} (CUDA {torch.version.cuda}) "
        f"sees {kind} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"built {', '.join(logs)} in {time.perf_counter() - t0:.1f}s")
    for name, text in logs.items():          # ptxas: registers, spills, smem
        for line in text.splitlines():
            if "Used" in line or ("spill" in line and " 0 bytes spill" not in line):
                log(f"ptxas {name}: {line.strip()}")

    seconds = {"build": time.perf_counter() - t0}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        log(f"phase {name}: {seconds[name]:.1f}s")
        return out

    main_cases = timed("kernels", phase_kernels, torch)
    timed("small", phase_small, torch)
    counts = timed("serve", phase_serve, torch, card)
    timed("profile", phase_profile, torch)
    fleet_counts, captured, in_run, world = timed("fleet", phase_fleet, torch)
    main_cases.update(timed("fleet_kernels", phase_fleet_kernels, torch,
                            captured, in_run))
    del captured
    win_rec, ctrl_rec, adm_counts, adm_sims = timed(
        "fleet_admission", phase_fleet_admission, torch, world)
    timed("fleet_batching", phase_fleet_batching, torch, world, adm_sims)
    del adm_sims
    timed("replan", phase_replan, torch, world)
    main_cases["admission_window"] = win_rec
    main_cases["admission_ctrl"] = ctrl_rec
    mixed = [name for name, rec in main_cases.items() if not rec["hidden"]]
    if mixed:
        raise SmokeFailure(f"kernel device time not separable from the "
                           f"host's: {mixed}")
    counts = dict(counts, deposit=fleet_counts["deposit"],
                  backlog_scan=fleet_counts["backlog_scan"],
                  admission_window=adm_counts["admission_window"],
                  admission_ctrl=adm_counts["admission_ctrl"])
    log(f"phase seconds {json.dumps({k: round(v, 1) for k, v in seconds.items()})}"
        f", total {time.perf_counter() - t0:.1f}s")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    sources = {
        "gmm": ("src/repro_torch/kernels/csrc/moe_gmm.cu",
                "src/repro/kernels/moe_gmm.py:54"),
        "decode_attention": ("src/repro_torch/kernels/csrc/decode_attn.cu",
                             "src/repro/kernels/decode_attn.py:83"),
        "deposit": ("src/repro_torch/kernels/csrc/deposit.cu",
                    "src/repro/kernels/deposit.py:147"),
        "backlog_scan": ("src/repro_torch/kernels/csrc/backlog_scan.cu",
                         "src/repro/traffic/queueing.py:553"),
        "admission_window": ("src/repro_torch/kernels/csrc/admission_window.cu",
                             "src/repro/traffic/queueing.py:589"),
        "admission_ctrl": ("src/repro_torch/kernels/csrc/admission_ctrl.cu",
                           "src/repro/traffic/queueing.py:589"),
    }
    kernels = []
    for name, rec in main_cases.items():
        rec = dict(rec, route="cuda", source=sources[name][0],
                   replaces=sources[name][1], launches=counts[name])
        kernels.append({k: rec[k] for k in keys})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"[chip_smoke] FAILED: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)
