"""Elastic re-placement + straggler mitigation (fault tolerance layer).

The paper's link outages (Eq. 3) map to device/link failures on the TPU
torus.  When the device set degrades, the Theorem-1 machinery re-derives
the expert->device mapping over the survivors; the diff between the old
and new plans is the minimal weight-migration set.  Stragglers are the
soft version: a slow device keeps its slots but its expected cost is
inflated, so the re-plan drains hot experts away from it.

A copy of ``repro.distributed.elastic`` (host numpy), held bitwise to it.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.activation import activation_probs
from ..core.device_placement import (DevicePlacementPlan, TorusSpec,
                                         hop_cost_s)
from ..core.placement import theorem1_assignment


@dataclasses.dataclass
class Migration:
    """Weight movement needed to adopt a new placement plan."""

    moved_experts: np.ndarray          # expert ids that change device
    bytes_moved: float
    old_devices: np.ndarray
    new_devices: np.ndarray


def _plan_from_costs(router_weights: np.ndarray, top_k: int,
                     device_cost: np.ndarray, devices: np.ndarray,
                     n_experts: int, origin: int) -> DevicePlacementPlan:
    epd = -(-n_experts // len(devices))          # ceil: multi-expert slots
    slot_cost = np.repeat(device_cost, epd)
    probs = activation_probs(router_weights, top_k)
    assign = theorem1_assignment(probs, slot_cost)       # expert -> slot
    perm = np.full(len(devices) * epd, -1, dtype=np.int64)  # -1 = empty slot
    perm[assign] = np.arange(n_experts)
    return DevicePlacementPlan(
        expert_perm=perm,
        device_cost_s=device_cost,
        experts_per_device=epd,
        origin=origin,
    )


def replan_on_failure(
    router_weights: np.ndarray,
    top_k: int,
    torus: TorusSpec,
    failed_devices: set[int],
    origin: int = 0,
    bytes_per_token: float = 2 * 4096.0,
) -> tuple[DevicePlacementPlan, np.ndarray]:
    """Re-derive placement on the surviving device set.

    Returns (plan, survivor device ids).  Experts per surviving device grows
    to ceil(E / survivors) — the Sec. VI-B multi-expert regime kicks in
    automatically when capacity shrinks.
    """
    survivors = np.array(
        [d for d in range(torus.n_devices) if d not in failed_devices]
    )
    if len(survivors) == 0:
        raise ValueError("no surviving devices")
    if origin in failed_devices:
        origin = int(survivors[0])
    hops = torus.hop_distance(origin)[survivors]
    cost = 2.0 * hop_cost_s(hops, bytes_per_token)
    plan = _plan_from_costs(router_weights, top_k, cost, survivors,
                            len(router_weights), origin)
    return plan, survivors


def replan_with_stragglers(
    router_weights: np.ndarray,
    top_k: int,
    torus: TorusSpec,
    straggler_slowdown: dict[int, float],
    origin: int = 0,
    bytes_per_token: float = 2 * 4096.0,
) -> DevicePlacementPlan:
    """Inflate straggler costs and re-run Theorem 1 (soft mitigation)."""
    devices = np.arange(torus.n_devices)
    hops = torus.hop_distance(origin)
    cost = 2.0 * hop_cost_s(hops, bytes_per_token)
    for dev, slow in straggler_slowdown.items():
        cost[dev] = cost[dev] * slow + 1e-6 * (slow - 1.0)
    return _plan_from_costs(router_weights, top_k, cost, devices,
                            len(router_weights), origin)


def migration(old: DevicePlacementPlan, new: DevicePlacementPlan,
              bytes_per_expert: float,
              new_devices: np.ndarray | None = None) -> Migration:
    """Experts whose hosting device changes between two plans."""
    n_exp = old.n_experts
    old_dev = np.array([old.device_of_expert(e) for e in range(n_exp)])
    dev_ids = (np.arange(len(new.device_cost_s)) if new_devices is None
               else np.asarray(new_devices))
    new_dev = dev_ids[new.inverse_perm[:n_exp] // new.experts_per_device]
    moved = np.where(old_dev != new_dev)[0]
    return Migration(
        moved_experts=moved,
        bytes_moved=float(len(moved) * bytes_per_expert),
        old_devices=old_dev[moved],
        new_devices=new_dev[moved],
    )
