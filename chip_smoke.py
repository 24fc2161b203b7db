#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no success line):

  1. the card: ``nvidia-smi`` name and power limit, torch's device name;
  2. build: compile every kernel of the serve path from ``csrc/`` with
     nvcc for sm_90a (one nvcc per source, started together);
  3. kernels: each CUDA kernel against its plain PyTorch version on the
     card at the serve path's shapes (plus an f32, a ragged and a long
     case, and gmm at a real prefill's C = 2560), with its device time
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
     device busy share, kernel time by name);
  7. fleet: the request-level fleet simulator (``repro_torch.traffic
     .FleetSim``) on the paper's world (33 x 32 satellites, 200 slots,
     llama-moe-3.5b's 32 MoE layers, 8 experts top-2, 3 plans, ~132
     requests, analytic service, ``QueueConfig()``): built on the card,
     ``run()`` with the launch counts of ``deposit`` and ``backlog_scan``
     checked, the device busy share of one ``run()``, ``run_many`` over
     11 thinning fractions, and the CPU (plain versions) held to the card
     on ``run()`` and on the two smallest fractions, which must serve
     requests;
  8. fleet kernels: ``deposit`` and ``backlog_scan`` on the inputs that
     ``run()`` gave them, each against its plain version (bitwise), with
     device times, the plain version's and the library call's time, and
     the least time the card could take;
  9. the ``kernels`` JSON line (all four kernels; launches counted over
     the serve run for gmm/decode_attention and over the fleet ``run()``
     for deposit/backlog_scan), the card line, then the result line.

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
# Load-to-use latency of device memory assumed for the serial bound of a
# recursion that waited on each load (order of magnitude, not measured).
DRAM_LATENCY_S = 600e-9
# Thinning fractions of the fleet sweep (benchmarks/bench_fleet.py).
FLEET_FRACTIONS = (0.1, 0.15, 0.2, 0.25, 0.3, 0.35, 0.4, 0.5, 0.6, 0.8, 1.0)


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


def check_decode(torch, b, hkv, g, s, hd, dtype_name, pos_list, iters):
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attn
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(s + g)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for shape in ((b, hkv, g, hd), (b, hkv, s, hd), (b, hkv, s, hd)))
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
                "shape": f"q({b},{hkv},{g},{hd}) kv S={s} pos={pos_list} "
                         f"{dtype_name}",
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
    attn_cases = [
        (BATCH, 32, 1, 128, s_serve, "bfloat16", [last_pos] * BATCH),
        (BATCH, 32, 1, 128, 2048, "bfloat16", [2047, 1500, 1024, 17]),
        (2, 4, 3, 64, 333, "float32", [332, 100]),
    ]
    main = {}
    failed = []
    for case in gmm_cases:
        rec = check_gmm(torch, *case, iters=20)
        log("kernel " + json.dumps(rec))
        failed += [] if rec["ok"] else [rec["shape"]]
        if case == (e, cap_decode, d, f, "bfloat16"):
            main["gmm"] = rec
    for b, hkv, g, hd, s, dt, pos in attn_cases:
        rec = check_decode(torch, b, hkv, g, s, hd, dt, pos, iters=50)
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


# --------------------------------------------------------------------- #
# Phase 7: the fleet simulator on the paper's world
# --------------------------------------------------------------------- #


def fleet_world():
    """The paper's constellation, llama-moe-3.5b's MoE shape, 3 plans and
    a 60 s trace at 2 requests/s (seeded)."""
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
    return topo, act, plans, req


def build_fleet(world, device, seed=5):
    """``FleetSim`` over ``world``; ``seed`` seeds the engine's expert
    draws, which set the unloaded horizon and so T."""
    import numpy as np

    from repro_torch import core
    from repro_torch.traffic import FleetSim, QueueConfig
    topo, act, plans, req = world
    t0 = time.perf_counter()
    sim = FleetSim(plans, topo, act, core.MoEWorkload.llama_moe_3p5b(),
                   core.ComputeConfig(), req, np.random.default_rng(seed),
                   qcfg=QueueConfig(), device=device)
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


def phase_fleet(torch) -> tuple[dict, dict, dict]:
    """Returns (launch counts of run(), the kernels' captured inputs, their
    device ms per launch in the profiled run())."""
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

    def deposit_rec(rows, cols, vals, n_rows, n_cols, row_ptr):
        captured.setdefault("deposit", (
            rows.clone(), cols.clone(), vals.clone(), n_rows, n_cols,
            row_ptr.clone()))
        return real_deposit(rows, cols, vals, n_rows, n_cols,
                            row_ptr=row_ptr)

    def scan_rec(work, cap, dt):
        captured.setdefault("backlog_scan", (work.clone(), cap, dt))
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
    for _ in range(2):
        t0 = time.perf_counter()
        again = sim.run()
        torch_sync()
        walls.append(time.perf_counter() - t0)
    assert_parity(res, again, "card run() vs card run()", rtol=0.0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run()
        torch_sync()
        prof_wall = time.perf_counter() - t0
    kernels = device_times(prof, 1)
    in_run = {name: ms / calls for ms, calls, key in kernels
              for name in ("deposit", "backlog_scan")
              if f"{name}_kernel" in key}
    seen = {name: calls for _, calls, key in kernels
            for name in want if f"{name}_kernel" in key}
    if seen != want:
        raise SmokeFailure(f"the profiled fleet run() recorded launches "
                           f"{seen}, not {want}: its busy share would be "
                           "short")
    busy = sum(k[0] for k in kernels) / 1e3
    log(f"fleet run(): {min(walls) * 1e3:.1f} ms wall (best of 2, "
        f"synchronized); under the profiler {prof_wall * 1e3:.1f} ms wall, "
        f"device kernels {busy * 1e3:.1f} ms -> device busy "
        f"{busy / prof_wall:.1%}, idle {1 - busy / prof_wall:.1%} "
        f"({sum(k[1] for k in kernels):.0f} kernel launches)")
    for ms, calls, name in sorted(kernels, reverse=True)[:10]:
        log(f"fleet profile: {ms:9.3f} ms {calls:6.0f} calls  {name[:80]}")
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
    return counts, captured, in_run


# --------------------------------------------------------------------- #
# Phase 8: the fleet kernels on the inputs run() gave them
# --------------------------------------------------------------------- #


def phase_fleet_kernels(torch, captured, in_run) -> dict[str, dict]:
    """Each fleet kernel against its plain version on the inputs run()
    gave it.  ``in_run``: device ms per launch inside the profiled run()
    (printed beside the kernel's own time)."""
    from repro_torch.kernels import backlog_scan, deposit
    rows, cols, vals, n_rows, n_cols, row_ptr = captured["deposit"]
    got = deposit.deposit(rows, cols, vals, n_rows, n_cols, row_ptr=row_ptr)
    torch.cuda.synchronize()
    want = deposit.deposit_plain(rows, cols, vals, n_rows, n_cols)
    same = bool(torch.equal(got, want))
    n_real = int(row_ptr[-1])
    # What the function must move: each real triple's bin and value
    # (int64 + f64; rows are implied by row_ptr, the padding is not read),
    # row_ptr, and the f64 plane written once.
    nbytes = 16 * n_real + 8 * (n_rows + 1) + 8 * n_rows * n_cols
    b_ms, b_by = bound(nbytes, n_real, "float64")
    flat = rows * n_cols + cols

    def library():
        return torch.zeros(n_rows * n_cols, dtype=torch.float64,
                           device="cuda").index_put_((flat,), vals,
                                                     accumulate=True)
    dep = timed_record(
        torch, {"name": "deposit",
                "shape": f"{n_real} triples (+{rows.numel() - n_real} "
                         f"padding) into {n_rows} x {n_cols} f64",
                "max_abs_err": float((got - want).abs().max()),
                "tol": 0.0, "ok": same, "bound_ms": b_ms, "bound_by": b_by},
        kernel=lambda: deposit.deposit(rows, cols, vals, n_rows, n_cols,
                                       row_ptr=row_ptr),
        plain=lambda: deposit.deposit_plain(rows, cols, vals, n_rows, n_cols),
        library=library, iters=5)
    dep["in_run_ms"] = in_run["deposit"]
    log("kernel " + json.dumps(dep))

    work, cap, dt = captured["backlog_scan"]
    ms, wall_ms, hidden = time_ms(torch, lambda: backlog_scan.backlog_scan(
        work, cap, dt), iters=5)
    got = backlog_scan.backlog_scan(work, cap, dt)
    torch.cuda.synchronize()
    want = None

    def plain():
        nonlocal want
        want = backlog_scan.backlog_scan_plain(work, cap, dt)
    plain_ms = event_ms(torch, plain, iters=1, warm=False)
    same_scan = bool(torch.equal(got, want))
    t_bins, n_cols_scan = work.shape
    b_ms, b_by = bound(8 * work.numel(), 4 * work.numel(), "float32")
    scan = {"name": "backlog_scan",
            "shape": f"({t_bins}, {n_cols_scan}) f32 time-major",
            "max_abs_err": float((got - want).abs().max()), "tol": 0.0,
            "ok": same_scan, "bound_ms": b_ms, "bound_by": b_by,
            "serial_dram_ms": t_bins * DRAM_LATENCY_S * 1e3,
            "ms": ms, "wall_ms": wall_ms, "hidden": hidden,
            "plain_ms": plain_ms, "plain_wall_ms": plain_ms,
            "plain_hidden": False, "library_ms": None,
            "library_wall_ms": None, "in_run_ms": in_run["backlog_scan"]}
    log("kernel " + json.dumps(scan))
    if not (same and same_scan):
        raise SmokeFailure(f"fleet kernels disagree with their plain "
                           f"versions: deposit equal={same}, backlog_scan "
                           f"equal={same_scan}")
    return {"deposit": dep, "backlog_scan": scan}


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

    main_cases = phase_kernels(torch)
    phase_small(torch)
    counts = phase_serve(torch, card)
    phase_profile(torch)
    fleet_counts, captured, in_run = phase_fleet(torch)
    main_cases.update(phase_fleet_kernels(torch, captured, in_run))
    mixed = [name for name, rec in main_cases.items() if not rec["hidden"]]
    if mixed:
        raise SmokeFailure(f"kernel device time not separable from the "
                           f"host's: {mixed}")
    counts = dict(counts, deposit=fleet_counts["deposit"],
                  backlog_scan=fleet_counts["backlog_scan"])

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
