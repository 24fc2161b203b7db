"""SpaceMoE expert->device placement on a device torus, host numpy.

A copy of ``repro.core.device_placement``, held bitwise to it.  The
paper's constellation is a cylindrical 2-D mesh; the same machinery maps
onto a torus of accelerators:

  satellite            -> device (a coordinate on the torus)
  laser ISL hop        -> link hop (alpha + bytes/bandwidth)
  gateway satellite    -> the dispatch-origin shard of the MoE layer
  expected path latency tau_bar_s -> expected round-trip hop cost
  Theorem 1            -> expert->device permutation (hot experts near the
                          dispatch origin)

The resulting :class:`DevicePlacementPlan` is consumed by
``repro_torch.models.moe.apply_placement`` as a static permutation of the
expert axis.  The link constants are the reference's (a TPU ICI link), so
the dispatch costs printed by the serve driver equal the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .activation import activation_probs
from .objective import layer_latency_closed_form
from .placement import theorem1_assignment

# The reference's per-link constants (a v5e-class ICI link).
ICI_LINK_GBPS = 50.0
ICI_HOP_LATENCY_US = 1.0     # per-hop switching+serialization alpha


@dataclasses.dataclass(frozen=True)
class TorusSpec:
    """An ICI torus (or mesh) of devices, e.g. (16, 16) per pod."""

    shape: tuple[int, ...]
    wrap: bool = True     # torus (wraparound links) vs open mesh

    @property
    def n_devices(self) -> int:
        return int(np.prod(self.shape))

    def coords(self) -> np.ndarray:
        """(n_devices, ndim) integer coordinates, row-major device order."""
        grids = np.meshgrid(*[np.arange(s) for s in self.shape], indexing="ij")
        return np.stack([g.ravel() for g in grids], axis=1)

    def hop_distance(self, origin: int) -> np.ndarray:
        """Torus Manhattan hop count from ``origin`` to every device."""
        c = self.coords()
        d = np.abs(c - c[origin])
        if self.wrap:
            d = np.minimum(d, np.asarray(self.shape) - d)
        return d.sum(axis=1)

    def all_pair_hops(self) -> np.ndarray:
        c = self.coords()
        d = np.abs(c[:, None, :] - c[None, :, :])
        if self.wrap:
            d = np.minimum(d, np.asarray(self.shape) - d)
        return d.sum(axis=2)


def hop_cost_s(hops: np.ndarray, bytes_per_token: float) -> np.ndarray:
    """Per-destination dispatch cost: alpha*hops + store-and-forward bytes."""
    alpha = ICI_HOP_LATENCY_US * 1e-6
    bw = ICI_LINK_GBPS * 1e9
    return hops * alpha + np.where(hops > 0, bytes_per_token / bw, 0.0) * np.maximum(hops, 1)


@dataclasses.dataclass
class DevicePlacementPlan:
    """Static expert->device map for the EP axis of one MoE layer group.

    ``expert_perm`` reorders the expert axis: ``expert_perm[slot]`` is the
    expert id stored in EP slot ``slot`` (slots are laid out device-major,
    ``experts_per_device`` consecutive slots per device, devices sorted by
    the EP axis order of the mesh).  Slots may outnumber experts after an
    elastic re-plan; empty slots hold -1.
    """

    expert_perm: np.ndarray          # (n_slots,) slot -> expert id or -1
    device_cost_s: np.ndarray        # (n_devices,) expected round-trip cost
    experts_per_device: int
    origin: int

    @property
    def n_experts(self) -> int:
        return int((self.expert_perm >= 0).sum())

    @property
    def inverse_perm(self) -> np.ndarray:
        inv = np.full(self.n_experts, -1, dtype=np.int64)
        for slot, e in enumerate(self.expert_perm):
            if e >= 0:
                inv[e] = slot
        return inv                   # expert id -> slot

    def device_of_expert(self, expert: int) -> int:
        return int(self.inverse_perm[expert] // self.experts_per_device)


def plan_expert_devices(
    router_weights: np.ndarray,
    top_k: int,
    torus: TorusSpec,
    ep_devices: np.ndarray | None = None,
    origin: int = 0,
    bytes_per_token: float = 2 * 4096.0,
) -> DevicePlacementPlan:
    """Theorem-1 placement of E experts onto the EP device group.

    Parameters
    ----------
    router_weights: (E,) importance weights (e.g. softmax-mean gate stats).
    ep_devices:     device ids participating in expert parallelism
                    (default: all torus devices).
    origin:         dispatch-origin device (the paper's gateway analogue —
                    in SPMD all devices dispatch, so we use the EP-group
                    centroid by default; callers may pass the attention
                    shard owner for latency-bound decode).
    """
    devices = np.arange(torus.n_devices) if ep_devices is None else np.asarray(ep_devices)
    n_exp = len(router_weights)
    if n_exp % len(devices) != 0:
        raise ValueError(f"E={n_exp} not divisible by |EP group|={len(devices)}")
    epd = n_exp // len(devices)

    hops = torus.hop_distance(origin)[devices]
    cost = 2.0 * hop_cost_s(hops, bytes_per_token)      # dispatch + combine
    probs = activation_probs(np.asarray(router_weights, dtype=np.float64), top_k)

    # Sec. VI-B slotted rule: each device offers `epd` identical-cost slots.
    slot_cost = np.repeat(cost, epd)
    assign = theorem1_assignment(probs, slot_cost)       # expert -> slot
    perm = np.empty(n_exp, dtype=np.int64)
    perm[assign] = np.arange(n_exp)                      # slot -> expert
    return DevicePlacementPlan(
        expert_perm=perm, device_cost_s=cost, experts_per_device=epd, origin=origin
    )


def expected_dispatch_cost(
    plan: DevicePlacementPlan, router_weights: np.ndarray, top_k: int
) -> float:
    """Expected slowest-path cost (Eq. 33) of a device placement."""
    slot_cost = np.repeat(plan.device_cost_s, plan.experts_per_device)
    occupied = plan.expert_perm >= 0
    slot_cost = slot_cost[occupied]
    experts = plan.expert_perm[occupied]
    order = np.argsort(slot_cost, kind="stable")
    tau_sorted = slot_cost[order]
    # rank_to_expert: rank r holds expert experts[order[r]]
    rank_to_expert = experts[order]
    return layer_latency_closed_form(
        tau_sorted, np.asarray(router_weights, dtype=np.float64),
        rank_to_expert, top_k,
    )


def identity_plan(n_experts: int, torus: TorusSpec,
                  origin: int = 0, bytes_per_token: float = 2 * 4096.0
                  ) -> DevicePlacementPlan:
    """No-placement baseline (expert i on slot i) for A/B comparisons."""
    hops = torus.hop_distance(origin)
    cost = 2.0 * hop_cost_s(hops, bytes_per_token)
    epd = max(1, n_experts // torus.n_devices)
    return DevicePlacementPlan(
        expert_perm=np.arange(n_experts), device_cost_s=cost,
        experts_per_device=epd, origin=origin,
    )
