"""Serving driver: batched autoregressive decode with SpaceMoE placement.

Counterpart of ``repro.launch.serve``, steps 1-3:

  1. calibrate: one forward pass collecting per-layer expert-selection
     counts (the paper's activation statistics, Eq. 14 plug-in);
  2. plan: Theorem-1 expert->device placement per MoE layer on the EP
     ring (``repro_torch.core.device_placement``), applied as a weight
     permutation (``repro_torch.models.moe.apply_placement``);
  3. serve: prefill a batch of prompts, greedy-decode N tokens per
     request; report tokens/s.

On a CUDA device the expert FFNs run through the hand-written ``gmm``
kernel and decode attention through the ``decode_attention`` kernel.
Step 4 (``--space-sim`` / ``--traffic``) and the elastic demo
(``--fail-device``) are not yet ported and exit with an error.

    python -m repro_torch.launch.serve --arch llama-moe-3.5b \
        --batch 4 --prompt-len 32 --decode-tokens 16
    python -m repro_torch.launch.serve --smoke --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config, smoke_config
from ..core import (TorusSpec, expected_dispatch_cost, identity_plan,
                    plan_expert_devices)
from ..models import (cast_for_compute, forward, init_params, prefill,
                      random_batch)
from ..models.moe import apply_placement
from .steps import make_serve_step


def calibrate_router_stats(cfg, params, batch) -> np.ndarray | None:
    """(n_units, E) expert-selection counts from one forward pass."""
    if not cfg.has_moe:
        return None
    _, _, counts = forward(cfg, params, batch, return_router_stats=True)
    return counts.cpu().numpy()


def plan_and_apply_placement(cfg, params, counts: np.ndarray,
                             ep_ring: int = 16):
    """Per-unit Theorem-1 device placement, applied to the expert stacks."""
    e = cfg.n_experts
    ring = TorusSpec(shape=(min(ep_ring, e),), wrap=True)
    plans, costs = [], {"theorem1": 0.0, "identity": 0.0}
    for u in range(counts.shape[0]):
        w = counts[u] + 1e-3
        plan = plan_expert_devices(w, cfg.top_k, ring,
                                   bytes_per_token=2.0 * cfg.d_model)
        base = identity_plan(e, ring, bytes_per_token=2.0 * cfg.d_model)
        costs["theorem1"] += expected_dispatch_cost(plan, w, cfg.top_k)
        costs["identity"] += expected_dispatch_cost(base, w, cfg.top_k)
        plans.append(plan)

    width = len(cfg.pattern)
    layers = list(params["layers"])
    for i, lp in enumerate(layers):
        if "router" in lp["ffn"]:
            layers[i] = dict(lp, ffn=apply_placement(
                lp["ffn"], plans[i // width].expert_perm))
    return dict(params, layers=layers), plans, costs


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="llama-moe-3.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a card) or 'cpu', "
                         "where the kernels run as their plain versions")
    ap.add_argument("--no-placement", action="store_true",
                    help="A/B: skip the Theorem-1 placement")
    ap.add_argument("--space-sim", action="store_true",
                    help="also simulate the constellation latency "
                         "(not yet ported)")
    ap.add_argument("--traffic", default=None, metavar="SCENARIO",
                    help="request-level fleet simulation (not yet ported)")
    ap.add_argument("--fail-device", type=int, default=-1,
                    help="elastic demo: fail this EP device and re-plan "
                         "(not yet ported)")
    return ap


def run(argv=None) -> tuple[dict, dict]:
    """Steps 1-3.  Returns (out, state): ``out`` as the reference's serve
    returns it; ``state`` holds the last logits and the generated tokens
    for callers that check them."""
    ap = _parser()
    args = ap.parse_args(argv)
    for flag, given in (("--space-sim", args.space_sim),
                        ("--traffic", args.traffic is not None),
                        ("--fail-device", args.fail_device >= 0)):
        if given:
            ap.error(f"{flag} is not yet ported to repro_torch (serve steps "
                     "1-3 only); run it with python -m repro.launch.serve")

    device = resolve_device(args.device)
    if device.type == "cuda":
        # Full f32 matmuls, never TF32 (the reference's f32 is exact f32).
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = cast_for_compute(cfg, init_params(cfg, gen, device))
    return _serve(cfg, params, args, device)


def _serve(cfg, params, args, device) -> tuple[dict, dict]:
    out: dict = {"arch": cfg.name}

    # ---- 1-2: calibrate + place ---------------------------------------
    counts = None
    if cfg.has_moe:
        calib = random_batch(cfg, args.batch, args.prompt_len, seed=7,
                             device=device)
        counts = calibrate_router_stats(cfg, params, calib)
        if not args.no_placement:
            params, _, costs = plan_and_apply_placement(cfg, params, counts)
            red = (1 - costs["theorem1"] / costs["identity"]) * 100 \
                if costs["identity"] else 0.0
            out["dispatch_cost"] = costs
            print(f"[placement] expected dispatch cost: theorem1="
                  f"{costs['theorem1']*1e6:.1f}us identity="
                  f"{costs['identity']*1e6:.1f}us  (-{red:.1f}%)")

    # ---- 3: serve ------------------------------------------------------
    batch = random_batch(cfg, args.batch, args.prompt_len, seed=args.seed,
                         device=device)
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    max_len = args.prompt_len + args.decode_tokens + 1
    logits, cache = prefill(cfg, params, prompt, max_len=max_len)
    serve_step = make_serve_step(cfg)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    pos = torch.full((args.batch,), args.prompt_len, dtype=torch.int32,
                     device=device)
    generated = [tok]
    _synchronize(device)
    t0 = time.perf_counter()
    for _ in range(args.decode_tokens):
        tok, logits, cache = serve_step(params, cache, tok, pos)
        pos = pos + 1
        generated.append(tok)
    _synchronize(device)
    dt = time.perf_counter() - t0
    toks = args.batch * args.decode_tokens
    out["tokens_per_s"] = toks / dt
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("serve: non-finite logits after decode")
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"[serve] {toks} tokens in {dt:.2f}s -> {out['tokens_per_s']:.1f} "
          f"tok/s ({where})")
    return out, {"logits": logits, "tokens": torch.cat(generated, dim=1)}


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    return run(argv)[0]


if __name__ == "__main__":
    main()
