"""Serving driver: batched autoregressive decode with SpaceMoE placement.

Counterpart of ``repro.launch.serve``:

  1. calibrate: one forward pass collecting per-layer expert-selection
     counts (the paper's activation statistics, Eq. 14 plug-in);
  2. plan: Theorem-1 expert->device placement per MoE layer on the EP
     ring (``repro_torch.core.device_placement``; ``ep_ring_devices``
     devices), applied as a weight permutation
     (``repro_torch.models.moe.apply_placement``); with
     ``--fail-device`` the elastic demo fails one EP device, re-plans on
     the survivors and reports the migration bytes;
  3. serve: prefill a batch of prompts, greedy-decode N tokens per
     request; report tokens/s;
  4. account (``--space-sim``): the space-network latency of the same
     token stream on a 12-plane constellation, SpaceMoE vs
     RandIntra-CG in one batched ``evaluate_plans`` sweep;
     ``--traffic <scenario>`` upgrades it to the request-level fleet
     simulation of ``repro_torch.traffic`` (``run_scenario``) and prints
     the SLO table, with the admission, re-placement (``--ctrl`` host
     loop or joint control plane), batching, flight-recorder
     (``--trace``) and federation (``--federation K``) options of the
     reference.

Every registered architecture serves (``--arch``): models without MoE
(dense, and the recurrent xlstm-350m) skip steps 1-2 and 4, as in the
reference; jamba-1.5-large-398b's four MoE blocks a pattern unit share
that unit's router counts and placement; a vision model's prompts start
with patch embeddings, and an audio model's prompts are embeddings
throughout, with a frame embedding on every decode step.  On a CUDA
device the expert FFNs run through the hand-written ``gmm`` kernel and
decode attention through the ``decode_attention`` kernel, and every fleet
object of step 4 is built on ``--device``.

    python -m repro_torch.launch.serve --arch llama-moe-3.5b \
        --batch 4 --prompt-len 32 --decode-tokens 16
    python -m repro_torch.launch.serve --arch deepseek-moe-16b \
        --batch 4 --prompt-len 32 --decode-tokens 16
    python -m repro_torch.launch.serve --arch granite-moe-3b-a800m \
        --space-sim
    python -m repro_torch.launch.serve --arch llava-next-mistral-7b
    python -m repro_torch.launch.serve --arch xlstm-350m
    python -m repro_torch.launch.serve --smoke --arch jamba-1.5-large-398b \
        --space-sim
    python -m repro_torch.launch.serve --smoke --device cpu
    python -m repro_torch.launch.serve --smoke --device cpu \
        --traffic smoke --admission aimd --federation 2 --fail-device 0
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config, smoke_config
from ..core import (ActivationModel, ComputeConfig, Constellation,
                    ConstellationConfig, LinkConfig, MoEWorkload, TorusSpec,
                    evaluate_plans, expected_dispatch_cost, identity_plan,
                    plan_expert_devices, rand_intra_cg_plan, sample_topology,
                    simulate_token_generation_legacy, spacemoe_plan)
from ..distributed import migration, replan_on_failure
from ..models import Parallel, forward, init_params, prefill, random_batch
from ..models.moe import apply_placement
from .steps import make_serve_step


def calibrate_router_stats(cfg, params, batch) -> np.ndarray | None:
    """(n_scan_units, E) expert-selection counts from one forward pass:
    one row per MoE unit (a dense first layer has none)."""
    if not cfg.has_moe:
        return None
    _, _, counts = forward(cfg, params, batch, return_router_stats=True)
    return counts.cpu().numpy()


def ep_ring_devices(n_experts: int, ep_ring: int = 16) -> int:
    """Devices of step 2's EP ring: the reference's ``min(ep_ring, E)``,
    or, where that does not divide E (the reference's
    ``plan_expert_devices`` then raises: granite-moe-3b-a800m's 40
    experts on 16), the largest divisor of E below it (10 for 40)."""
    n = min(ep_ring, n_experts)
    while n_experts % n:
        n -= 1
    return n


def plan_and_apply_placement(cfg, params, counts: np.ndarray,
                             ep_ring: int = 16):
    """Per-unit Theorem-1 device placement, applied to the expert stacks.

    Unlike the reference (whose arrays are immutable), the permutation is
    applied in place: each MoE layer's ``ffn`` in ``params["layers"]`` is
    replaced as it is placed, so the device holds one layer's experts
    twice at a time, not the model's.  That lowers the peak: for
    deepseek-moe-16b (28 GiB of experts in bf16) it stays at the drawn
    model's 32.26 GiB, where copying every stack peaked at 58.46 GiB.
    Returns ``params`` itself."""
    e = cfg.n_experts
    ring = TorusSpec(shape=(ep_ring_devices(e, ep_ring),), wrap=True)
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
    for i, lp in enumerate(params["layers"]):
        if "router" in lp.get("ffn", {}):
            lp["ffn"] = apply_placement(lp["ffn"],
                                        plans[i // width].expert_perm)
    return params, plans, costs


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
                    help="also simulate the constellation latency")
    ap.add_argument("--traffic", default=None, metavar="SCENARIO",
                    help="request-level fleet simulation under a named "
                         "repro_torch.traffic scenario (implies "
                         "--space-sim)")
    ap.add_argument("--admission", default=None,
                    choices=["static", "aimd", "pid"],
                    help="admission policy for --traffic: 'static' forces "
                         "the KV-slot cap (--kv-slots), 'aimd' switches to "
                         "the latency-target controller with gateway retry, "
                         "'pid' swaps in the PID cell on the same qhat "
                         "signal")
    ap.add_argument("--ttft-target", type=float, default=30.0,
                    help="TTFT target (s) the aimd admission controller "
                         "defends (with --admission aimd)")
    ap.add_argument("--kv-slots", type=int, default=8,
                    help="static KV-slot budget applied with "
                         "--admission static (0 = uncapped)")
    ap.add_argument("--replan", default=None,
                    choices=["off", "periodic", "backlog"],
                    help="continuous re-placement for --traffic: 'off' "
                         "holds the plans for the whole horizon, "
                         "'periodic' re-ranks the candidate pool every "
                         "topology slot, 'backlog' additionally inflates "
                         "scores with the live per-satellite backlog "
                         "(adds a replan/<mode> row to the table)")
    ap.add_argument("--ctrl", default="host", choices=["host", "fused"],
                    help="controller implementation for --replan "
                         "scenarios: 'host' walks the decide law round "
                         "by round, 'fused' runs the joint control plane "
                         "in one call on the device (same decisions; the "
                         "exported trace gains the joint decision-event "
                         "channel)")
    ap.add_argument("--rate-scale", type=float, default=1.0,
                    help="multiply the --traffic scenario's arrival "
                         "rates (overload knob)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="with --traffic: run the fleet simulation with "
                         "probes and export the flight recorder as "
                         "Chrome/Perfetto trace-event JSON; also prints "
                         "the windowed fleet-telemetry table")
    ap.add_argument("--batching", type=int, default=0, metavar="B_MAX",
                    help="with --traffic: continuous decode batching in "
                         "the fleet queues, up to B_MAX decode steps a "
                         "bin at the service model's batch rate (0 = off)")
    ap.add_argument("--federation", type=int, default=0, metavar="K",
                    help="with --traffic: additionally serve the scenario "
                         "over a K-member constellation federation; "
                         "admission-shed requests overflow to the "
                         "next-best member (needs --admission aimd/pid "
                         "for overflow)")
    ap.add_argument("--fail-device", type=int, default=-1,
                    help="elastic demo: fail this EP device and re-plan")
    return ap


def run(argv=None) -> tuple[dict, dict]:
    """Steps 1-4.  Returns (out, state): ``out`` as the reference's serve
    returns it; ``state`` holds the last logits and the generated tokens
    for callers that check them."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        # Full f32 matmuls, never TF32 (the reference's f32 is exact f32).
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    params = init_params(cfg, gen, device)
    if device.type == "cuda":
        print(f"[init] {cfg.name}: weights "
              f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB in "
              f"{cfg.compute_dtype}, peak while drawing "
              f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
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
            if args.fail_device >= 0:
                w = counts.sum(axis=0) + 1e-3
                ring = TorusSpec(shape=(ep_ring_devices(cfg.n_experts),),
                                 wrap=True)
                plan0 = plan_expert_devices(w, cfg.top_k, ring)
                plan1, survivors = replan_on_failure(
                    w, cfg.top_k, ring, {args.fail_device})
                bytes_per_expert = 3 * cfg.d_model * cfg.d_ff_expert * 2
                mig = migration(plan0, plan1, bytes_per_expert, survivors)
                out["migration_bytes"] = mig.bytes_moved
                print(f"[elastic] device {args.fail_device} failed: "
                      f"{len(mig.moved_experts)} experts move, "
                      f"{mig.bytes_moved/1e6:.1f} MB")

    # ---- 3: serve ------------------------------------------------------
    batch = random_batch(cfg, args.batch, args.prompt_len, seed=args.seed,
                         device=device)
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    max_len = args.prompt_len + args.decode_tokens + 1
    par = Parallel(mesh=None)
    logits, cache = prefill(cfg, params, prompt, max_len=max_len, par=par)
    serve_step = make_serve_step(cfg, par)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    pos = torch.full((args.batch,), args.prompt_len, dtype=torch.int32,
                     device=device)
    # The audio frontend's stub: every decode step takes a frame embedding.
    emb = (torch.ones((args.batch, 1, cfg.d_model), dtype=torch.float32,
                      device=device)
           if cfg.frontend == "audio" else None)
    generated = [tok]
    _synchronize(device)
    t0 = time.perf_counter()
    # Grad off, so the serve step replays its CUDA graph on a card.
    with torch.no_grad():
        for _ in range(args.decode_tokens):
            tok, logits, cache = serve_step(params, cache, tok, pos, emb)
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

    # ---- 4: space-network latency accounting ---------------------------
    if (args.space_sim or args.traffic) and cfg.has_moe:
        _space_sim(cfg, counts, args, device, out)
    return out, {"logits": logits, "tokens": torch.cat(generated, dim=1)}


def plane_sats(n_layers: int, n_experts: int, n_planes: int) -> int:
    """Satellites a plane for step 4's world: the reference's 16, or the
    fewest that give every layer's ring subnet room for its experts and
    its gateway."""
    per_layer = -(-(n_experts + 1) // n_planes)
    return max(16, n_layers * per_layer)


def _space_sim(cfg, counts: np.ndarray, args, device, out: dict) -> None:
    """Step 4: the space-network latency of the router statistics'
    activation model on a 12-plane constellation, and with ``--traffic``
    the request-level fleet simulation (and ``--federation``), every
    simulator on ``device``; fills ``out`` with the reference's keys.

    The reference's world is 12 x 16.  SpaceMoE's placement gives each
    MoE layer a ring subnet of ``sats_per_plane // layers`` satellites in
    each of the 12 planes (``ring_subnets``), and each subnet must hold
    the layer's experts besides its gateway (``theorem1_assignment``).
    Where 16 satellites a plane cannot, the reference's serve raises; the
    port widens the planes to the fewest satellites that can
    (``plane_sats``): one a layer for llama-moe-3.5b's 32 layers, four a
    layer for granite-moe-3b-a800m's 32 layers of 40 experts, six a layer
    for deepseek-moe-16b's 27 layers of 64 experts."""
    n_layers = counts.shape[0]
    ccfg = ConstellationConfig.scaled(
        12, plane_sats(n_layers, cfg.n_experts, 12), n_slots=20)
    con = Constellation(ccfg)
    rng = np.random.default_rng(1)
    topo = sample_topology(con, LinkConfig(token_dim=cfg.d_model), rng)
    activ = ActivationModel.from_router_counts(counts, cfg.top_k)
    wl = MoEWorkload(
        d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        d_ff_expert=cfg.d_ff_expert, n_experts=cfg.n_experts,
        top_k=cfg.top_k, vocab_size=cfg.vocab_size,
    )
    comp = ComputeConfig()
    sweep = [
        spacemoe_plan(con, topo, activ, wl, comp),
        rand_intra_cg_plan(ccfg, n_layers, cfg.n_experts,
                           np.random.default_rng(3)),
    ]
    # One batched sweep; both plans share the rng(2) token stream,
    # exactly what the legacy per-plan path consumes.
    sm, cg = evaluate_plans(sweep, topo, activ, wl, comp,
                            np.random.default_rng(2), n_tokens=200,
                            device=device)
    if args.smoke:
        for plan, res in zip(sweep, (sm, cg)):
            ref = simulate_token_generation_legacy(
                plan, topo, activ, wl, comp, np.random.default_rng(2),
                n_tokens=200)
            if abs(res.mean_s - ref.mean_s) / ref.mean_s >= 1e-5:
                raise RuntimeError(
                    f"engine/legacy divergence for {plan.name}")
    out["space_latency_s"] = {"SpaceMoE": sm.mean_s,
                              "RandIntra-CG": cg.mean_s}
    print(f"[space-sim] s/token: SpaceMoE={sm.mean_s:.3f} "
          f"RandIntra-CG={cg.mean_s:.3f} "
          f"({cg.mean_s/sm.mean_s:.2f}x reduction)")
    if not args.traffic:
        return

    # ---- --traffic: the named scenario through run_scenario --------------
    from ..traffic import (AdmissionConfig, ReplanConfig,
                           build_ground_segment, format_table, get_scenario,
                           run_scenario)
    sc = get_scenario(args.traffic)
    if args.replan is not None:
        # Re-placement needs slot boundaries inside the horizon; keep the
        # scenario's own period when it pins one.
        sc = dataclasses.replace(
            sc,
            replan=(None if args.replan == "off"
                    else ReplanConfig(mode=args.replan)),
            slot_period_s=sc.slot_period_s or 60.0)
    if args.admission in ("aimd", "pid"):
        sc = dataclasses.replace(
            sc, kv_slots=0,
            admission=AdmissionConfig(policy=args.admission,
                                      ttft_target_s=args.ttft_target),
            slo=dataclasses.replace(sc.slo, ttft_s=args.ttft_target))
    elif args.admission == "static":
        sc = dataclasses.replace(sc, admission=None, kv_slots=args.kv_slots)
    if args.smoke:
        horizon = min(sc.horizon_s, 60.0)
        sc = dataclasses.replace(
            sc, horizon_s=horizon, tail_s=60.0,
            failure_at_s=(horizon / 2.0
                          if sc.failure_at_s is not None else None))
    ground = build_ground_segment(con, LinkConfig(token_dim=cfg.d_model),
                                  min_elevation_deg=10.0)
    sim_kwargs = {"device": device}
    fused_replan = args.ctrl == "fused" and sc.replan is not None
    if args.trace:
        if fused_replan:
            # The control plane records no probe rings; the exported
            # trace carries the request spans plus the joint
            # decision-event channel instead.
            print("[trace] fused controller: probe rings off, joint "
                  "decision channel on")
        else:
            from ..obs import ProbeConfig
            sim_kwargs["probes"] = ProbeConfig()
    if args.batching > 0:
        from ..traffic import BatchingConfig
        sim_kwargs["batching"] = BatchingConfig(b_max=args.batching)
    res = run_scenario(sc, sweep, topo, activ, wl, comp,
                       np.random.default_rng(4), ground=ground,
                       constellation=con, rate_scale=args.rate_scale,
                       ctrl=args.ctrl, **sim_kwargs)
    rows = res.result.table(sc.slo, scenario=sc.name)
    if res.post_failure is not None:
        rows += res.post_failure.table(sc.slo, scenario=f"{sc.name}(post)")
    print(format_table(rows, prefix="[traffic] "))
    out["traffic"] = rows
    for tag, rep in (("replan", res.replan),
                     ("replan(post)", res.post_replan)):
        if rep is None:
            continue
        print(f"[{tag}] {rep.schedule.name}: {rep.n_switches} switch(es), "
              f"{rep.total_migration_bytes/1e6:.1f} MB migrated over "
              f"{len(rep.decisions)} decision(s)")
        out[tag] = {"switches": rep.n_switches,
                    "migration_bytes": rep.total_migration_bytes}
    if args.federation > 0:
        from ..traffic import FederationConfig, make_federation
        fed_sc = dataclasses.replace(sc, replan=None)
        fed = make_federation(
            fed_sc, args.federation, ccfg, wl, comp,
            np.random.default_rng(6),
            fed_cfg=FederationConfig(overflow=fed_sc.admission is not None),
            rate_scale=args.rate_scale, n_layers=n_layers,
            n_experts=cfg.n_experts, top_k=cfg.top_k, device=device)
        fres = fed.run()
        frow = fres.federated.row(fed_sc.slo)
        frows = [{"scenario": f"{sc.name}(fed)", **frow}]
        for k, mem in enumerate(fres.members):
            mrow = mem.plans[fed.serve_plan].row(fed_sc.slo)
            mrow["plan"] = f"member{k}/{mrow['plan']}"
            frows.append({"scenario": f"{sc.name}(fed)", **mrow})
        print(format_table(frows, prefix="[federation] "))
        print(f"[federation] K={args.federation} members, "
              f"{fres.n_rounds} overflow round(s) (one fixed point each), "
              f"{int((fres.hops > 0).sum())} request(s) re-routed")
        out["federation"] = {
            "rows": frows, "n_rounds": fres.n_rounds,
            "n_rerouted": int((fres.hops > 0).sum()),
        }
    if args.trace:
        from ..obs import build_flight_log, summarize_timeseries, write_trace
        log = build_flight_log(res.sim, res.result, replan=res.replan,
                               scenario=sc.name)
        trace = write_trace(args.trace, log)
        tw = summarize_timeseries(res.sim.last_probes, plan=log.plan)
        if tw:
            print(format_table(tw, prefix="[telemetry] "))
        print(f"[trace] {len(trace['traceEvents'])} events "
              f"({len(log.requests)} requests, {len(log.events)} control "
              f"instants) -> {args.trace}")
        out["trace"] = {"path": args.trace,
                        "n_events": len(trace["traceEvents"]),
                        "n_control_events": len(log.events)}


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    return run(argv)[0]


if __name__ == "__main__":
    main()
