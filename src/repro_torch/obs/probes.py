"""Probe ring buffers of the fleet fixed point (counterpart of
``repro.obs.probes``; host numpy, the reference's code).

The reference writes preallocated ring buffers from inside its backlog
and admission scans, one write per time bin into the slot ``(bin //
stride) % capacity`` (bins the stride skips write a sentinel scratch
slot), during the final fixed-point iteration only.  The port's scans do
not write per bin: ``FleetSim`` takes the channels after the final
iteration by gathers at the bins :func:`ring_bins` says survive and
fills the same buffers (:func:`make_buffers`), so the ring's contents,
and :meth:`ProbeRecord.from_launch`'s unwrapping of them, are the
reference's.

Host side, :meth:`ProbeRecord.from_launch` unwraps the rings (the slot
-> bin mapping is recomputed by :func:`ring_bins`) and expands the
compacted (plan, satellite) queue rows back to the full fleet.
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: Ring-buffer channels recorded per (sweep entry, queue row) per bin.
ROW_CHANNELS = ("backlog", "util", "drops")
#: Fourth row channel, recorded only under continuous batching: the
#: per-(row, bin) effective decode batch occupancy B_eff.
BATCH_CHANNEL = "batch_b"
#: Extra channels recorded under AIMD admission.
ADMISSION_CHANNELS = ("qhat", "admit", "win")
#: Decision-event channel emitted by the joint control plane — one
#: entry per decide boundary of the fused replan walk.
DECISION_CHANNELS = ("scores", "chosen", "switched", "mig_bytes")


@dataclasses.dataclass
class DecisionTrace:
    """The joint controller's decision-event channel, host-unwrapped.

    One entry per decide boundary of one fused control launch (the
    replan walk of the reference's ``FleetSim.run_replan_grid``) — the
    device telemetry of the decide loop, not a
    host re-derivation, so an exported trace shows exactly what the
    launch chose.  D decisions, C candidates.

    Attributes:
        period_s: Wall-clock seconds per slot boundary.
        boundaries: (D,) boundary index k of each decision (t = k *
            ``period_s``).
        slots: (D,) topology slot entered at each boundary.
        scores: (D, C) backlog-inflated predicted cost per candidate.
        chosen: (D,) candidate index in effect after each boundary.
        switched: (D,) bool — the boundary changed the incumbent.
        migration_bytes: (D,) bytes the switch moved (0.0 on holds).
    """

    period_s: float
    boundaries: np.ndarray
    slots: np.ndarray
    scores: np.ndarray
    chosen: np.ndarray
    switched: np.ndarray
    migration_bytes: np.ndarray

    @property
    def n_decisions(self) -> int:
        """Decide boundaries recorded (D)."""
        return int(self.boundaries.size)

    @property
    def n_switches(self) -> int:
        """Boundaries whose decision changed the incumbent plan."""
        return int(self.switched.sum())

    @property
    def t_s(self) -> np.ndarray:
        """(D,) wall-clock seconds of each decision's boundary."""
        return self.boundaries.astype(np.float64) * self.period_s


@dataclasses.dataclass(frozen=True)
class ProbeConfig:
    """Fleet telemetry probe parameters (static per launch).

    Attributes:
        capacity: Ring slots.  When the horizon
            has more recorded bins than slots the ring wraps and only
            the last ``capacity`` recorded bins survive.
        stride: Record every ``stride``-th time bin; ``None`` derives
            the smallest stride that makes one horizon fit the ring
            (``ceil(n_bins / capacity)``) — whole-run coverage at
            bounded memory.
    """

    capacity: int = 256
    stride: int | None = None

    def __post_init__(self):
        """Validate the probe parameters."""
        if self.capacity < 1:
            raise ValueError("probe capacity must be >= 1")
        if self.stride is not None and self.stride < 1:
            raise ValueError("probe stride must be >= 1 (or None)")

    def resolve(self, n_bins: int) -> tuple[int, int]:
        """The ``(capacity, stride)`` pair for an ``n_bins``-bin
        horizon."""
        stride = self.stride if self.stride is not None \
            else max(1, -(-int(n_bins) // self.capacity))
        return int(self.capacity), int(stride)


def make_buffers(capacity: int, n_sweep: int, n_rows: int,
                 admit_shape: tuple[int, int] | None,
                 n_row_channels: int = len(ROW_CHANNELS)) -> dict:
    """Zeroed host-side ring buffers for one probed launch.

    One extra slot (index ``capacity``) is the sentinel scratch target
    for non-recorded bins.  The buffers hold no ``bin`` channel: the
    slot -> bin mapping is a pure function of ``(n_bins, capacity,
    stride)``, which :func:`ring_bins` recomputes.

    Args:
        capacity: Ring slots (the extra sentinel slot is added here).
        n_sweep: Leading sweep axis F of the launch.
        n_rows: Compacted (plan, satellite) queue-row count.
        admit_shape: ``(n_plans, n_gateways)`` to also allocate the AIMD
            channels; ``None`` for uncontrolled runs.
        n_row_channels: Row channels to allocate — ``len(ROW_CHANNELS)``
            normally, one more under continuous batching (the
            ``BATCH_CHANNEL`` occupancy plane rides the same write).

    Returns:
        Dict of numpy arrays: the rings of one probed launch.
    """
    c1 = int(capacity) + 1
    # The row channels share one stacked buffer (axis 1 ordered as
    # ROW_CHANNELS [+ BATCH_CHANNEL]); so do the two (F, P) AIMD
    # channels (axis 1 = qhat, win).
    bufs = {
        "rows": np.zeros((c1, int(n_row_channels), n_sweep, n_rows),
                         dtype=np.float32),
    }
    if admit_shape is not None:
        n_plans, n_gw = admit_shape
        bufs["aimd"] = np.zeros((c1, 2, n_sweep, n_plans),
                                dtype=np.float32)
        bufs["admit"] = np.zeros((c1, n_sweep, n_plans, n_gw),
                                 dtype=np.float32)
    return bufs


def ring_bins(n_bins: int, capacity: int,
              stride: int) -> tuple[np.ndarray, np.ndarray]:
    """(slots, bins) the ring holds after one full scan of ``n_bins``.

    The scan visits every bin in order and records each ``stride``-th
    one into slot ``(bin // stride) % capacity``, so slot ``s`` ends up
    holding the *last* recorded index congruent to ``s`` — no device
    bookkeeping needed.  Both arrays come back sorted by bin
    (ascending); ``slots`` indexes the ring axis of the raw buffers.
    """
    n_rec = -(-int(n_bins) // int(stride))         # recorded indices
    used = min(n_rec, int(capacity))
    slots = np.arange(used)
    k_last = slots + capacity * ((n_rec - 1 - slots) // capacity)
    bins = k_last * stride
    order = np.argsort(bins, kind="stable")
    return slots[order], bins[order]


@dataclasses.dataclass
class ProbeRecord:
    """One probed launch's telemetry, unwrapped to host arrays.

    B recorded bins (ascending), F sweep entries, P plans, S satellites,
    M engine tokens, L layers, G gateways.

    Attributes:
        dt_s: Seconds per time bin.
        capacity: Ring capacity the launch ran with.
        stride: Bin stride the launch recorded at.
        bins: (B,) recorded bin indices, ascending.
        backlog_s: (B, F, P, S) per-satellite queue backlog (seconds of
            work) at each recorded bin's start.
        util_s: (B, F, P, S) work deposited into the queue during the
            recorded bin (seconds; divide by ``dt_s`` for utilization).
        drops_s: (B, F, P, S) seconds of work beyond the buffer cap in
            the recorded bin (overflow pressure).
        qhat_s: (B, F, P) AIMD critical-path backlog estimate (gateway
            chain + per-layer worst expert); None without admission.
        admit: (B, F, P, G) per-gateway admit probability after the
            bin's control action; None without admission.
        win_s: (B, F, P) the controller's running window-max qhat;
            None without admission.
        gw_wait_s: (F, P, M, L) final-iteration gateway queue wait per
            token and layer (the queueing half of the Eq. 43 layer
            breakdown the flight recorder reports).
        ex_wait_s: (F, P, M, L) final-iteration worst expert-branch
            queue wait per token and layer.
        batch_b: (B, F, P, S) effective decode batch occupancy B_eff at
            each recorded bin (>= 1 wherever decode work landed); None
            unless the launch ran with continuous batching.
    """

    dt_s: float
    capacity: int
    stride: int
    bins: np.ndarray
    backlog_s: np.ndarray
    util_s: np.ndarray
    drops_s: np.ndarray
    qhat_s: np.ndarray | None = None
    admit: np.ndarray | None = None
    win_s: np.ndarray | None = None
    gw_wait_s: np.ndarray | None = None
    ex_wait_s: np.ndarray | None = None
    batch_b: np.ndarray | None = None

    @property
    def n_recorded(self) -> int:
        """Number of recorded bins that survived the ring (B)."""
        return int(self.bins.size)

    @property
    def t_s(self) -> np.ndarray:
        """(B,) wall-clock seconds of each recorded bin's start."""
        return self.bins.astype(np.float64) * self.dt_s

    @property
    def admission_on(self) -> bool:
        """True iff the AIMD channels were recorded."""
        return self.qhat_s is not None

    @classmethod
    def from_launch(cls, raw: dict, gw_wait: np.ndarray | None,
                    ex_wait: np.ndarray | None, dt_s: float,
                    capacity: int, stride: int, n_bins: int,
                    expand_rows) -> "ProbeRecord":
        """Unwrap one launch's ring buffers.

        Args:
            raw: The ``probes`` output pytree (host arrays, sentinel
                slot still attached).
            gw_wait: (F, P, M, L) final gateway waits (or None).
            ex_wait: (F, P, M, L) final expert waits (or None).
            dt_s: Seconds per bin.
            capacity: Ring capacity of the launch.
            stride: Recording stride of the launch.
            n_bins: Bin count T of the launch's horizon (fixes the
                slot -> bin mapping, see :func:`ring_bins`).
            expand_rows: ``FleetSim._expand_rows`` — scatters the
                compact-row last axis back to (..., P, S).
        """
        slots, bins = ring_bins(n_bins, capacity, stride)

        def unwrap(arr, expand):
            arr = np.asarray(arr)[slots]
            return expand_rows(arr) if expand else arr

        rows = {name: unwrap(raw["rows"][:, i], True)
                for i, name in enumerate(ROW_CHANNELS)}
        extra = {}
        # A fourth row channel means the launch ran under continuous
        # batching and recorded the B_eff occupancy plane.
        if np.asarray(raw["rows"]).shape[1] > len(ROW_CHANNELS):
            extra["batch_b"] = unwrap(
                raw["rows"][:, len(ROW_CHANNELS)], True)
        if "aimd" in raw:
            extra.update(qhat_s=unwrap(raw["aimd"][:, 0], False),
                         win_s=unwrap(raw["aimd"][:, 1], False),
                         admit=unwrap(raw["admit"], False))
        return cls(
            dt_s=float(dt_s), capacity=int(capacity), stride=int(stride),
            bins=bins,
            backlog_s=rows["backlog"],
            util_s=rows["util"],
            drops_s=rows["drops"],
            gw_wait_s=None if gw_wait is None else np.asarray(gw_wait),
            ex_wait_s=None if ex_wait is None else np.asarray(ex_wait),
            **extra)
