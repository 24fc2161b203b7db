"""E2E token-generation latency simulator (paper Sec. IV-B protocol).

Per token: sample a topology snapshot n ~ U{1..N_T} (as in Sec. VII-A2),
then for each layer l

    tau_l = T_gateway + max_{i in S_hat_l} [ D(phi_l, sat(i); n) + T_expert
                                             + D(sat(i), phi_{l+1}; n) ]

with S_hat_l ~ conditional-Poisson top-K (Eq. 12), and the ring wrap for
the last layer (Eq. 22).  Token latency = sum_l tau_l (+ lm head on the
last gateway).

Counterpart of ``repro.core.simulator``.  ``simulate_token_generation``
is a thin wrapper over the batched engine (:mod:`.engine`, PyTorch on the
given device), preserving the historical single-plan API and random
stream.  The original NumPy per-layer loop is kept as
``simulate_token_generation_legacy`` (the reference's host numpy, held
bitwise to it) — the golden reference the engine is compared against.
"""
from __future__ import annotations

import numpy as np

from .activation import ActivationModel
from .engine import HOP_SCALE_S, SimResult, evaluate_plans
from .latency import ComputeConfig, TopologySample, gateway_distance_table
from .placement import MultiExpertPlan, PlacementPlan
from .workload import MoEWorkload

__all__ = ["SimResult", "simulate_token_generation",
           "simulate_token_generation_legacy"]


def simulate_token_generation(
    plan: PlacementPlan | MultiExpertPlan,
    topo: TopologySample,
    activation: ActivationModel,
    workload: MoEWorkload,
    compute: ComputeConfig,
    rng: np.random.Generator,
    n_tokens: int = 1000,
    ctx_len: int = 1024,
    include_lm_head: bool = True,
    eta: float = 1.0,
    node_sets: list | None = None,
    route_staleness: int = 0,
    reroute_penalty_s: float = 0.0,
    backend: str = "engine",
    device="cuda",
) -> SimResult:
    """Monte-Carlo E2E latency under a placement plan.

    For :class:`MultiExpertPlan` the per-satellite contention term of
    Eq. 43 is applied: an activated satellite running q experts pays
    (q/eta) * T_expert.  ``node_sets`` restricts routing per layer
    (intra-subnet mode; see placement.subnet_routing_sets).

    Link-state awareness (paper Sec. VIII open challenge):
    ``route_staleness`` = s > 0 means paths are *chosen* from the topology
    s slots ago but *traversed* on the current one — when the stale choice
    is broken or slower, the token pays the current shortest path plus
    ``reroute_penalty_s`` (discovery/handshake).  s = 0 is the
    link-state-aware ideal the rest of the paper assumes.

    ``backend="engine"`` (default) runs the batched engine with P=1 on
    ``device`` (CUDA unless the caller asks for the CPU);
    ``backend="numpy"`` runs the legacy float64 reference on the host.
    Both consume the same random stream from ``rng``.
    """
    if backend == "numpy":
        return simulate_token_generation_legacy(
            plan, topo, activation, workload, compute, rng,
            n_tokens=n_tokens, ctx_len=ctx_len,
            include_lm_head=include_lm_head, eta=eta, node_sets=node_sets,
            route_staleness=route_staleness,
            reroute_penalty_s=reroute_penalty_s,
        )
    if backend != "engine":
        raise ValueError(f"unknown backend {backend!r}")
    return evaluate_plans(
        [plan], topo, activation, workload, compute, rng,
        n_tokens=n_tokens, ctx_len=ctx_len,
        include_lm_head=include_lm_head, eta=eta, node_sets=node_sets,
        route_staleness=route_staleness, reroute_penalty_s=reroute_penalty_s,
        device=device,
    )[0]


def simulate_token_generation_legacy(
    plan: PlacementPlan | MultiExpertPlan,
    topo: TopologySample,
    activation: ActivationModel,
    workload: MoEWorkload,
    compute: ComputeConfig,
    rng: np.random.Generator,
    n_tokens: int = 1000,
    ctx_len: int = 1024,
    include_lm_head: bool = True,
    eta: float = 1.0,
    node_sets: list | None = None,
    route_staleness: int = 0,
    reroute_penalty_s: float = 0.0,
) -> SimResult:
    """Reference NumPy implementation (one plan, Python loop over layers)."""
    n_layers = activation.n_layers
    dist = gateway_distance_table(topo, plan.gateways, node_sets)  # (N_T,L,V)

    t_gateway = compute.latency_s(workload.gateway_flops(ctx_len))
    t_expert = compute.latency_s(workload.expert_flops)
    t_head = compute.latency_s(workload.lm_head_flops) if include_lm_head else 0.0

    slots = rng.integers(0, topo.n_slots, size=n_tokens)
    multi = isinstance(plan, MultiExpertPlan)

    stale_slots = (slots - route_staleness) % topo.n_slots

    def hop_latency(layer_idx, sats):
        cur = np.take_along_axis(dist[slots, layer_idx], sats, axis=1)
        if route_staleness == 0:
            return cur
        # Stale routing table: smooth orbital drift is free (the old path
        # still works, its latency just moved), but a *topology* change —
        # the stale route detours by at least one extra hop (>~2 ms) or
        # broke entirely — forces discovery + re-route on the current
        # graph: latency = current shortest path + penalty.
        stale = np.take_along_axis(dist[stale_slots, layer_idx], sats, axis=1)
        broken = (np.abs(stale - cur) > HOP_SCALE_S) | ~np.isfinite(stale)
        return cur + reroute_penalty_s * broken

    layer_lat = np.empty((n_tokens, n_layers), dtype=np.float64)
    for layer in range(n_layers):
        nxt = (layer + 1) % n_layers
        draws = activation.sample(layer, rng, n_tokens)        # (n_tokens, K)
        sats = plan.expert_sats[layer][draws]                  # (n_tokens, K)
        d_out = hop_latency(layer, sats)
        d_in = hop_latency(nxt, sats)
        if multi:
            # contention: q_s = number of activated experts colocated on the
            # same satellite for this token (Eq. 43).
            q = (sats[:, :, None] == sats[:, None, :]).sum(axis=2)
            t_exp = (q / eta) * t_expert
        else:
            t_exp = t_expert
        layer_lat[:, layer] = t_gateway + (d_out + t_exp + d_in).max(axis=1)

    # Tokens whose routing hits an unreachable satellite in that slot are
    # undeliverable: count them as drops (NaN), never as infinite latency.
    layer_lat = np.where(np.isfinite(layer_lat), layer_lat, np.nan)
    token_lat = layer_lat.sum(axis=1) + t_head
    return SimResult(
        token_latency_s=token_lat, layer_latency_s=layer_lat,
        plan_name=getattr(plan, "name", "plan"),
    )
