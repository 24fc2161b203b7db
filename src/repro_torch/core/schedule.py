"""Time-indexed placement: one plan per topology slot (`PlanSchedule`).

The paper derives a placement once for the time-varying graph G(n)
(Sec. II, Eq. 2-3) and holds it for the whole horizon.  This module
makes the plan a first-class *function of the slot index n*: a
:class:`PlanSchedule` maps every topology slot to a placement plan and
carries explicit **migration edges** between consecutive slots — the
experts whose hosting satellite changes at the boundary, with the weight
bytes that transfer (the same accounting
the reference's ``distributed.elastic.migration`` uses on the device ring;
``tests/test_schedule.py`` pins the parity on a hand-checked switch).

A constant schedule (the same plan in every slot) is the degenerate case
and must reproduce the static engine path bit-for-bit — that invariant
is what lets every existing scenario become a re-placement testbed: the
engine (`repro_torch.core.engine.evaluate_schedules`), the fleet simulator
(`repro_torch.traffic.queueing.FleetSim`) and the re-placement controller
(`repro_torch.traffic.replan`) all consume schedules; plain plans are
wrapped by :func:`as_schedule` at the boundary.

A copy of ``repro.core.schedule`` (host numpy), held bitwise to it.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .placement import MultiExpertPlan, PlacementPlan


def slot_of_time(t_s: np.ndarray | float, slot_period_s: float,
                 n_slots: int) -> np.ndarray:
    """Topology slot in effect at wall-clock time ``t_s`` (wraps every
    orbital period: slot = floor(t / period) mod N_T)."""
    return (np.asarray(t_s, dtype=np.float64) // slot_period_s
            ).astype(np.int64) % n_slots


@dataclasses.dataclass
class ScheduleMigration:
    """Weight movement across one slot boundary of a schedule.

    Attributes:
        slot: Topology slot being *entered* (the edge is slot-1 -> slot,
            with ring wrap; -1 marks a free-standing plan-to-plan diff).
        layers: (n_moved,) layer of each moved expert.
        experts: (n_moved,) expert index within its layer.
        old_sats: (n_moved,) satellite the expert leaves.
        new_sats: (n_moved,) satellite the expert lands on.
        bytes_moved: Total weight bytes transferred over ISLs.
    """

    slot: int
    layers: np.ndarray
    experts: np.ndarray
    old_sats: np.ndarray
    new_sats: np.ndarray
    bytes_moved: float

    @property
    def n_moved(self) -> int:
        """Number of (layer, expert) pairs that change satellite."""
        return len(self.layers)


def migration_between(old_plan, new_plan, bytes_per_expert: float,
                      slot: int = -1) -> ScheduleMigration:
    """Experts whose hosting satellite changes between two plans.

    The constellation-side face of
    the reference's ``distributed.elastic.migration``: same rule (an expert
    moves iff its host changes), same byte accounting
    (``n_moved * bytes_per_expert``), applied per layer over the
    (L, I) expert->satellite maps instead of the device ring.
    """
    old_sats = np.asarray(old_plan.expert_sats)
    new_sats = np.asarray(new_plan.expert_sats)
    if old_sats.shape != new_sats.shape:
        raise ValueError("plans disagree on (n_layers, n_experts)")
    layers, experts = np.nonzero(old_sats != new_sats)
    return ScheduleMigration(
        slot=slot, layers=layers, experts=experts,
        old_sats=old_sats[layers, experts],
        new_sats=new_sats[layers, experts],
        bytes_moved=float(len(layers) * bytes_per_expert),
    )


def migration_matrix(plans: list, bytes_per_expert: float,
                     n_stations: int) -> tuple[np.ndarray, np.ndarray]:
    """All-pairs migration accounting for a candidate pool.

    The on-device re-placement controller decides plan switches inside
    one fused launch, so the per-switch quantities —
    :func:`migration_between` applied to every ordered (incumbent,
    successor) pair — must be precomputed as dense tables it can gather
    from.  Entry [i, j] prices the switch plans[i] -> plans[j] with
    exactly the walk's arithmetic (``n_moved * bytes_per_expert`` in one
    float64 product; diagonal entries are zero).

    Args:
        plans: Candidate pool (shared (n_layers, n_experts)).
        bytes_per_expert: Weight bytes one moved expert drags.
        n_stations: Satellite count V (the destination-count axis).

    Returns:
        ``(bytes_mat, dest_count)``: bytes_mat is (C, C) float64 bytes
        moved per ordered pair; dest_count is (C, C, V) float64 — how
        many moved experts land on each destination satellite (the
        per-boundary occupancy multiplier for the migration background
        load).
    """
    C = len(plans)
    bytes_mat = np.zeros((C, C))
    dest_count = np.zeros((C, C, n_stations))
    for i in range(C):
        for j in range(C):
            if i == j:
                continue
            mig = migration_between(plans[i], plans[j], bytes_per_expert)
            bytes_mat[i, j] = mig.bytes_moved
            if mig.n_moved:
                dest_count[i, j] = np.bincount(mig.new_sats,
                                               minlength=n_stations)
    return bytes_mat, dest_count


@dataclasses.dataclass
class PlanSchedule:
    """A per-topology-slot plan sequence with migration edges.

    ``plans`` holds the distinct plans the schedule uses;
    ``slot_plan[n]`` is the index of the plan in effect during topology
    slot n.  All plans must agree on (n_layers, n_experts) so tokens of
    any slot traverse the same station universe.

    Attributes:
        plans: Distinct :class:`~repro_torch.core.placement.PlacementPlan` /
            :class:`~repro_torch.core.placement.MultiExpertPlan` entries.
        slot_plan: (n_slots,) plan index per topology slot.
        name: Display name (one row of a sweep table).
    """

    plans: list
    slot_plan: np.ndarray
    name: str = "schedule"

    def __post_init__(self):
        self.slot_plan = np.asarray(self.slot_plan, dtype=np.int64)
        if not self.plans:
            raise ValueError("empty schedule")
        if self.slot_plan.ndim != 1 or len(self.slot_plan) == 0:
            raise ValueError("slot_plan must be a non-empty 1-D index array")
        if self.slot_plan.min() < 0 or self.slot_plan.max() >= len(self.plans):
            raise ValueError("slot_plan index out of range")
        shapes = {np.asarray(p.expert_sats).shape for p in self.plans}
        if len(shapes) != 1:
            raise ValueError("all plans of a schedule must share "
                             "(n_layers, n_experts)")

    @classmethod
    def constant(cls, plan, n_slots: int,
                 name: str | None = None) -> "PlanSchedule":
        """The degenerate schedule: one plan held for every slot (must
        reproduce the static engine path bit-for-bit)."""
        return cls(plans=[plan], slot_plan=np.zeros(n_slots, dtype=np.int64),
                   name=name or getattr(plan, "name", "plan"))

    @property
    def n_slots(self) -> int:
        """Number of topology slots the schedule covers (N_T)."""
        return len(self.slot_plan)

    @property
    def n_layers(self) -> int:
        """MoE layers shared by every plan of the schedule (L)."""
        return len(self.plans[0].gateways)

    @property
    def n_experts(self) -> int:
        """Experts per layer shared by every plan (I)."""
        return np.asarray(self.plans[0].expert_sats).shape[1]

    @property
    def is_constant(self) -> bool:
        """True iff the same plan is in effect in every slot."""
        return bool((self.slot_plan == self.slot_plan[0]).all())

    def plan_at(self, slot: int):
        """The plan in effect during topology slot ``slot``."""
        return self.plans[int(self.slot_plan[slot])]

    def switch_slots(self) -> np.ndarray:
        """Slots n >= 1 whose plan differs from slot n-1 (the boundaries
        that cost a migration; the 0 -> N_T-1 ring wrap is handled by
        the wall-clock walk in :meth:`migrations_over`)."""
        return 1 + np.flatnonzero(np.diff(self.slot_plan) != 0)

    def migration_edges(self, bytes_per_expert: float
                        ) -> list[ScheduleMigration]:
        """One :class:`ScheduleMigration` per in-sequence plan switch."""
        return [
            migration_between(self.plans[self.slot_plan[n - 1]],
                              self.plans[self.slot_plan[n]],
                              bytes_per_expert, slot=int(n))
            for n in self.switch_slots()
        ]

    def migrations_over(self, horizon_s: float, slot_period_s: float,
                        bytes_per_expert: float
                        ) -> list[tuple[float, ScheduleMigration]]:
        """(boundary time, migration) pairs for every plan switch a
        wall-clock walk of ``[0, horizon_s)`` crosses (slot indices wrap
        every orbital period, so a long horizon replays the sequence)."""
        out: list[tuple[float, ScheduleMigration]] = []
        n_bounds = int(np.floor(horizon_s / slot_period_s))
        for k in range(1, n_bounds + 1):
            prev = int(self.slot_plan[(k - 1) % self.n_slots])
            cur = int(self.slot_plan[k % self.n_slots])
            if prev == cur:
                continue
            out.append((k * slot_period_s,
                        migration_between(self.plans[prev], self.plans[cur],
                                          bytes_per_expert,
                                          slot=k % self.n_slots)))
        return out

    def total_migration_bytes(self, bytes_per_expert: float) -> float:
        """Sum of weight bytes over every in-sequence switch."""
        return float(sum(e.bytes_moved
                         for e in self.migration_edges(bytes_per_expert)))


def as_schedule(plan_or_schedule, n_slots: int) -> PlanSchedule:
    """Normalize a sweep entry: plans become constant schedules, existing
    schedules are validated against the topology's slot count."""
    if isinstance(plan_or_schedule, PlanSchedule):
        if plan_or_schedule.n_slots != n_slots:
            raise ValueError(
                f"schedule covers {plan_or_schedule.n_slots} slots but the "
                f"topology has {n_slots}")
        return plan_or_schedule
    if not isinstance(plan_or_schedule, (PlacementPlan, MultiExpertPlan)):
        raise TypeError(f"not a plan or schedule: {plan_or_schedule!r}")
    return PlanSchedule.constant(plan_or_schedule, n_slots)
