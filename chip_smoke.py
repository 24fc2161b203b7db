#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no success line):

  1. the card: ``nvidia-smi`` name and power limit, torch's device name;
  2. build: compile every kernel of the serve path from ``csrc/`` with
     nvcc for sm_90a (one nvcc per source, started together);
  3. kernels: each CUDA kernel against its plain PyTorch version on the
     card at the serve path's shapes (plus an f32, a ragged and a long
     case), with its device time (torch.profiler) and wall time (CUDA
     events), the same for the plain version and for one PyTorch library
     call as a yardstick, and the least time the card could take;
  4. small input: the serve path at smoke size on the card (kernels)
     against the same weights on the CPU (plain versions);
  5. full serve: ``repro_torch.launch.serve`` for llama-moe-3.5b at its
     published width and depth (batch 4, prompt 32, 16 decode tokens),
     with every kernel's launch count over that run checked;
  6. profile: where a full-width decode step's time goes (torch.profiler:
     device busy share, kernel time by name);
  7. the ``kernels`` JSON line, the card line, then the result line.

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
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


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


def time_ms(torch, fn, iters: int, warmup: int = 3) -> tuple[float, float]:
    """(device ms, wall ms) per call of ``fn()``.

    Device ms: the summed time of the kernels ``fn`` launched, from
    torch.profiler (for small kernels the host's launch gaps would
    otherwise count).  Wall ms: CUDA events around ``iters`` back-to-back
    calls, host gaps included.
    """
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    wall = start.elapsed_time(end) / iters
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev = sum(t[0] for t in device_times(prof, iters))
    if dev <= 0:
        raise SmokeFailure("torch.profiler recorded no device time")
    return dev, wall


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
    got = moe_gmm.gmm(x, w)
    torch.cuda.synchronize()
    want = moe_gmm.gmm_plain(x, w)
    tol = 2e-2 if dtype_name == "bfloat16" else 2e-5
    err = float((got.float() - want.float()).abs().max())
    ok = bool(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol))
    esize = x.element_size()
    b_ms, b_by = bound((x.numel() + w.numel() + e * c * n) * esize,
                       2.0 * e * c * k * n, dtype_name)
    return timed_record(
        torch, {"name": "gmm",
                "shape": f"x({e},{c},{k}) w({e},{k},{n}) {dtype_name}",
                "max_abs_err": err, "tol": tol, "ok": ok,
                "bound_ms": b_ms, "bound_by": b_by},
        kernel=lambda: moe_gmm.gmm(x, w),
        plain=lambda: moe_gmm.gmm_plain(x, w),
        library=lambda: torch.bmm(x, w), iters=iters)


def timed_record(torch, rec, kernel, plain, library, iters) -> dict:
    """``rec`` with device and wall times of the kernel, its plain version
    and the library call."""
    for key, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        rec[key + "ms"], rec[key + "wall_ms"] = time_ms(torch, fn, iters)
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
    gmm_cases = [(e, c, kk, nn, "bfloat16") for c in (cap_decode, cap_prefill)
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
    from repro_torch.kernels import ops
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
    if counts != want:
        raise SmokeFailure(f"launch counts {counts} != expected {want}")
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

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    sources = {
        "gmm": ("src/repro_torch/kernels/csrc/moe_gmm.cu",
                "src/repro/kernels/moe_gmm.py:54"),
        "decode_attention": ("src/repro_torch/kernels/csrc/decode_attn.cu",
                             "src/repro/kernels/decode_attn.py:83"),
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
