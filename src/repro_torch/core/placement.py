"""Two-level MoE placement (paper Sec. IV-C/D + Sec. V Theorem 1).

Level 1 — layer placement: partition the cylindrical mesh into L ring-
aligned subnets (Eq. 17), one MoE layer each; the ring wrap-around matches
the autoregressive layer->layer->first-layer dataflow (Remark 1).

Level 2 — intra-layer placement: central gateway (Eq. 18) and the
Theorem-1 expert->satellite assignment (hot experts on low expected-path-
latency satellites).  Baselines RandPlace / RandIntra / RandIntra-CG from
Sec. VII-A3 and the multi-expert extension of Sec. VI-B are included.

A copy of ``repro.core.placement`` (host numpy), held bitwise to it;
``rank_plans`` calls the port's engine.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .activation import ActivationModel
from .constellation import Constellation, ConstellationConfig
from .latency import (ComputeConfig, TopologySample, expected_path_latency,
                      gateway_distance_table)
from .workload import MoEWorkload


@dataclasses.dataclass
class PlacementPlan:
    """A full expert/gateway -> satellite mapping for an L-layer MoE."""

    gateways: np.ndarray          # (L,) node index of gateway satellite phi_l
    expert_sats: np.ndarray       # (L, I) node index hosting expert i of layer l
    name: str = "plan"
    # Diagnostics (filled by the optimizer when available):
    tau_bar: np.ndarray | None = None       # (L, I) expected path latency of chosen sats
    expert_rank: np.ndarray | None = None   # (L, I) latency rank of expert i

    @property
    def n_layers(self) -> int:
        return len(self.gateways)

    @property
    def n_experts(self) -> int:
        return self.expert_sats.shape[1]

    def validate(self, n_sats: int) -> None:
        used = np.concatenate([self.gateways, self.expert_sats.ravel()])
        if used.min() < 0 or used.max() >= n_sats:
            raise ValueError("satellite index out of range")
        # one sub-network per satellite (paper Sec. IV-D assumption)
        if len(np.unique(used)) != used.size:
            raise ValueError("a satellite hosts more than one sub-network")


# --------------------------------------------------------------------- #
# Level 1 — ring subnets + central gateways
# --------------------------------------------------------------------- #


def ring_subnets(cfg: ConstellationConfig, n_layers: int) -> list[np.ndarray]:
    """Eq. 17: L disjoint subnets along the ring (intra-orbit) direction."""
    if cfg.sats_per_plane < n_layers:
        raise ValueError(f"need N_y >= L, got N_y={cfg.sats_per_plane}, L={n_layers}")
    y_span = cfg.sats_per_plane // n_layers
    subnets = []
    for layer in range(n_layers):
        ys = np.arange(layer * y_span, (layer + 1) * y_span)
        nodes = (np.arange(cfg.n_planes)[:, None] * cfg.sats_per_plane + ys[None, :])
        subnets.append(nodes.ravel())
    return subnets


def central_gateway(cfg: ConstellationConfig, layer: int, n_layers: int) -> int:
    """Eq. 18: gateway at the subnet centre."""
    y_span = cfg.sats_per_plane // n_layers
    x = cfg.n_planes // 2
    y = layer * y_span + (y_span - 1) // 2
    return cfg.sat_index(x, y)


def subnet_routing_sets(cfg: ConstellationConfig, n_layers: int) -> list:
    """Per-layer node sets emulating intra-subnet-only routing: layer l may
    route over subnets {l-1, l, l+1} (its own plus the adjacent ones its
    dispatch/combine hops touch) instead of the whole constellation.  Used
    for the fidelity study in EXPERIMENTS.md §Paper-claims."""
    subnets = ring_subnets(cfg, n_layers)
    return [
        np.concatenate([subnets[(l - 1) % n_layers], subnets[l],
                        subnets[(l + 1) % n_layers]])
        for l in range(n_layers)
    ]


# --------------------------------------------------------------------- #
# Level 2 — Theorem-1 expert placement
# --------------------------------------------------------------------- #


def theorem1_assignment(
    activation_probs: np.ndarray, tau_bar: np.ndarray
) -> np.ndarray:
    """Theorem 1: expert with i-th highest P -> satellite with i-th lowest tau.

    Parameters
    ----------
    activation_probs: (I,) per-expert activation probabilities.
    tau_bar:          (C,) expected path latency per candidate satellite,
                      C >= I.

    Returns (I,) candidate indices: entry i = candidate hosting expert i.
    """
    n_exp = len(activation_probs)
    if len(tau_bar) < n_exp:
        raise ValueError("fewer candidate satellites than experts")
    # Stable sorts for deterministic tie-breaking.
    expert_order = np.argsort(-np.asarray(activation_probs), kind="stable")
    sat_order = np.argsort(np.asarray(tau_bar), kind="stable")[:n_exp]
    assign = np.empty(n_exp, dtype=np.int64)
    assign[expert_order] = sat_order
    return assign


def _layer_tau_bar(
    dist_table: np.ndarray,
    layer: int,
    n_layers: int,
    candidates: np.ndarray,
    compute_s: float,
) -> np.ndarray:
    tau_all = expected_path_latency(dist_table, layer, n_layers, compute_s)
    return tau_all[candidates]


def spacemoe_plan(
    constellation: Constellation,
    topo: TopologySample,
    activation: ActivationModel,
    workload: MoEWorkload | None = None,
    compute: ComputeConfig | None = None,
    ctx_len: int = 1024,
) -> PlacementPlan:
    """Full SpaceMoE placement: ring subnets + central gateways + Theorem 1."""
    cfg = constellation.cfg
    n_layers, n_experts = activation.n_layers, activation.n_experts
    subnets = ring_subnets(cfg, n_layers)
    gateways = np.array(
        [central_gateway(cfg, l, n_layers) for l in range(n_layers)], dtype=np.int64
    )
    dist = gateway_distance_table(topo, gateways)

    # Constant per-candidate compute offset (does not change the ordering,
    # but keeps tau_bar in true seconds for diagnostics).
    t_cmp = 0.0
    if workload is not None and compute is not None:
        t_cmp = compute.latency_s(workload.gateway_flops(ctx_len)) + \
            compute.latency_s(workload.expert_flops)

    expert_sats = np.empty((n_layers, n_experts), dtype=np.int64)
    tau_chosen = np.empty((n_layers, n_experts), dtype=np.float64)
    ranks = np.empty((n_layers, n_experts), dtype=np.int64)
    for layer in range(n_layers):
        cand = subnets[layer][subnets[layer] != gateways[layer]]
        tau = _layer_tau_bar(dist, layer, n_layers, cand, t_cmp)
        probs = activation.probs(layer)
        assign = theorem1_assignment(probs, tau)
        expert_sats[layer] = cand[assign]
        tau_chosen[layer] = tau[assign]
        order = np.argsort(tau, kind="stable")
        rank_of_candidate = np.empty(len(cand), dtype=np.int64)
        rank_of_candidate[order] = np.arange(len(cand))
        ranks[layer] = rank_of_candidate[assign]

    plan = PlacementPlan(
        gateways=gateways, expert_sats=expert_sats, name="SpaceMoE",
        tau_bar=tau_chosen, expert_rank=ranks,
    )
    plan.validate(cfg.n_sats)
    return plan


# --------------------------------------------------------------------- #
# Benchmark baselines (paper Sec. VII-A3)
# --------------------------------------------------------------------- #


def rand_place_plan(
    cfg: ConstellationConfig, n_layers: int, n_experts: int, rng: np.random.Generator
) -> PlacementPlan:
    """RandPlace: gateways + experts uniformly over the whole constellation."""
    total = n_layers * (1 + n_experts)
    picks = rng.choice(cfg.n_sats, size=total, replace=False)
    gateways = picks[:n_layers]
    experts = picks[n_layers:].reshape(n_layers, n_experts)
    plan = PlacementPlan(gateways=gateways, expert_sats=experts, name="RandPlace")
    plan.validate(cfg.n_sats)
    return plan


def rand_intra_plan(
    cfg: ConstellationConfig, n_layers: int, n_experts: int, rng: np.random.Generator
) -> PlacementPlan:
    """RandIntra: ring subnets, but gateway + experts random within each."""
    subnets = ring_subnets(cfg, n_layers)
    gateways = np.empty(n_layers, dtype=np.int64)
    experts = np.empty((n_layers, n_experts), dtype=np.int64)
    for layer, nodes in enumerate(subnets):
        picks = rng.choice(nodes, size=1 + n_experts, replace=False)
        gateways[layer] = picks[0]
        experts[layer] = picks[1:]
    plan = PlacementPlan(gateways=gateways, expert_sats=experts, name="RandIntra")
    plan.validate(cfg.n_sats)
    return plan


def rand_intra_cg_plan(
    cfg: ConstellationConfig, n_layers: int, n_experts: int, rng: np.random.Generator
) -> PlacementPlan:
    """RandIntra-CG: central gateway (Eq. 18), random experts in the subnet."""
    subnets = ring_subnets(cfg, n_layers)
    gateways = np.array(
        [central_gateway(cfg, l, n_layers) for l in range(n_layers)], dtype=np.int64
    )
    experts = np.empty((n_layers, n_experts), dtype=np.int64)
    for layer, nodes in enumerate(subnets):
        cand = nodes[nodes != gateways[layer]]
        experts[layer] = rng.choice(cand, size=n_experts, replace=False)
    plan = PlacementPlan(gateways=gateways, expert_sats=experts, name="RandIntra-CG")
    plan.validate(cfg.n_sats)
    return plan


# --------------------------------------------------------------------- #
# Sec. VI-B — multi-expert satellites
# --------------------------------------------------------------------- #


@dataclasses.dataclass
class MultiExpertPlan:
    """Expert -> satellite mapping allowing up to N_E experts per satellite."""

    gateways: np.ndarray
    expert_sats: np.ndarray       # (L, I): satellite hosting expert i
    experts_per_sat: int
    name: str = "multi-expert"


def multi_expert_plan(
    constellation: Constellation,
    topo: TopologySample,
    activation: ActivationModel,
    experts_per_sat: int,
    mode: str = "slotted",
    eta: float = 1.0,
    expert_latency_s: float = 0.0,
) -> MultiExpertPlan:
    """Sec. VI-B placement with N_E >= 1 experts per satellite.

    mode="slotted"  (propagation-limited regime): each satellite offers N_E
        identical latency slots; fill ascending-latency slots with experts
        in descending activation order — the natural Theorem-1 extension.
    mode="spread"   (compute-limited regime): assign the I hottest experts
        round-robin across the ceil(I/N_E) lowest-latency satellites so hot
        experts do not contend on the same node (Eq. 43 contention term).
    """
    cfg = constellation.cfg
    n_layers, n_experts = activation.n_layers, activation.n_experts
    subnets = ring_subnets(cfg, n_layers)
    gateways = np.array(
        [central_gateway(cfg, l, n_layers) for l in range(n_layers)], dtype=np.int64
    )
    dist = gateway_distance_table(topo, gateways)

    n_sats_needed = int(np.ceil(n_experts / experts_per_sat))
    expert_sats = np.empty((n_layers, n_experts), dtype=np.int64)
    for layer in range(n_layers):
        cand = subnets[layer][subnets[layer] != gateways[layer]]
        tau = _layer_tau_bar(dist, layer, n_layers, cand, 0.0)
        order = cand[np.argsort(tau, kind="stable")][:n_sats_needed]
        hot_first = np.argsort(-activation.probs(layer), kind="stable")
        if mode == "slotted":
            # expert ranks 0..I-1 fill satellite slots in blocks of N_E
            sat_of_rank = order[np.arange(n_experts) // experts_per_sat]
        elif mode == "spread":
            sat_of_rank = order[np.arange(n_experts) % n_sats_needed]
        else:
            raise ValueError(f"unknown mode {mode!r}")
        expert_sats[layer, hot_first] = sat_of_rank
    return MultiExpertPlan(
        gateways=gateways, expert_sats=expert_sats,
        experts_per_sat=experts_per_sat, name=f"multi-expert/{mode}",
    )


# --------------------------------------------------------------------- #
# Plan sweeps over the batched engine
# --------------------------------------------------------------------- #


def baseline_plans(
    constellation: Constellation,
    topo: TopologySample,
    activation: ActivationModel,
    rng: np.random.Generator,
    n_random_draws: int = 3,
    workload: MoEWorkload | None = None,
    compute: ComputeConfig | None = None,
    ctx_len: int = 1024,
) -> list[PlacementPlan]:
    """The Sec. VII-A3 candidate set as one sweep list: SpaceMoE plus
    ``n_random_draws`` draws of each random baseline, numbered so every
    plan in the sweep has a distinct name."""
    cfg = constellation.cfg
    n_layers, n_experts = activation.n_layers, activation.n_experts
    plans: list[PlacementPlan] = [
        spacemoe_plan(constellation, topo, activation, workload, compute,
                      ctx_len=ctx_len)
    ]
    for maker in (rand_place_plan, rand_intra_plan, rand_intra_cg_plan):
        for draw in range(n_random_draws):
            p = maker(cfg, n_layers, n_experts, rng)
            p.name = f"{p.name}#{draw}"
            plans.append(p)
    return plans


def rank_plans(
    plans: list,
    topo: TopologySample,
    activation: ActivationModel,
    workload: MoEWorkload,
    compute: ComputeConfig,
    rng: np.random.Generator,
    n_tokens: int = 500,
    **kwargs,
) -> list[tuple]:
    """Evaluate a candidate-plan sweep in one batched engine pass and
    return (plan, SimResult) pairs ordered best-first by (drop_rate,
    mean latency): ``mean_s`` excludes undeliverable tokens, so ranking
    on it alone would reward plans that drop their worst tokens —
    delivery comes first, speed second.

    Common random numbers across plans (see ``engine.evaluate_plans``)
    make this the low-variance comparison the continuous-re-placement
    loop needs at every topology slot.
    """
    from .engine import evaluate_plans  # deferred: engine imports this module
    results = evaluate_plans(plans, topo, activation, workload, compute, rng,
                             n_tokens=n_tokens, **kwargs)
    order = sorted(range(len(results)),
                   key=lambda i: (results[i].drop_rate, results[i].mean_s))
    return [(plans[i], results[i]) for i in order]
