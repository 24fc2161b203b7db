"""Request flight recorder: per-request lifecycle + control-plane events
(counterpart of ``repro.obs.recorder``; host numpy, the reference's
code).

Host-side assembly, run *after* a fleet launch: the fleet simulator's
construction tables (ingress mapping, zero-load Eq. 43 layer costs),
the launch outputs digested into :class:`~repro_torch.traffic.metrics
.PlanTraffic` rows, and the :class:`~repro_torch.obs.probes.ProbeRecord`
are joined into one :class:`FlightLog` — per-request records with
prefill/decode spans and a per-layer latency breakdown (zero-load hop
terms + the final iteration's queueing waits), plus the control-plane
event stream (AIMD admit changes read off the probe ring, re-placement
decisions read off the controller's ``ReplanReport``: its decisions and,
from the joint control plane, its ``DecisionTrace``).
"""
from __future__ import annotations

import dataclasses
import typing

import numpy as np

from .probes import ProbeRecord

if typing.TYPE_CHECKING:                              # pragma: no cover
    from ..traffic.metrics import TrafficResult
    from ..traffic.queueing import FleetSim
    from ..traffic.replan import ReplanReport


@dataclasses.dataclass
class RequestRecord:
    """One request's lifecycle under one plan row.

    Spans are wall-clock seconds; per-layer arrays have length L.

    Attributes:
        rid: Request index in the trace.
        station: Ground-station (gateway) index the request entered at.
        arrival_s: Arrival wall-clock time.
        prompt_len: Prompt tokens.
        decode_len: Decode tokens.
        active: Participated in the run (thinning mask).
        served: Fully delivered.
        shed: Rejected by the admission controller.
        retries: Gateway-retry attempts used (0 = first gateway).
        ingress_s: Uplink + ingress-hop + retry overhead before prefill.
        ttft_s: Time to first token (NaN unless served).
        tpot_s: Time per output token (NaN unless served).
        e2e_s: Completion time (NaN unless served).
        layer_zero_s: (L,) zero-load Eq. 43 per-layer cost of the
            prefill macro-token (hops + service + colocation).
        layer_gw_wait_s: (L,) gateway queue wait per layer, final
            fixed-point iteration (None without probes).
        layer_ex_wait_s: (L,) worst expert-branch queue wait per layer,
            final fixed-point iteration (None without probes).
        batch_b: Mean effective decode batch occupancy (B_eff) over the
            request's decode span at its plan's gateway satellites —
            the per-request batch span of a continuous-batching run
            (NaN without batching probes or when no recorded bin falls
            inside the span).
    """

    rid: int
    station: int
    arrival_s: float
    prompt_len: int
    decode_len: int
    active: bool
    served: bool
    shed: bool
    retries: int
    ingress_s: float
    ttft_s: float
    tpot_s: float
    e2e_s: float
    layer_zero_s: np.ndarray
    layer_gw_wait_s: np.ndarray | None = None
    layer_ex_wait_s: np.ndarray | None = None
    batch_b: float = float("nan")

    @property
    def prefill_span(self) -> tuple[float, float]:
        """(start, end) of the prefill span — arrival to first token."""
        return self.arrival_s, self.arrival_s + self.ttft_s

    @property
    def decode_span(self) -> tuple[float, float]:
        """(start, end) of the decode span — first token to completion."""
        return self.arrival_s + self.ttft_s, self.arrival_s + self.e2e_s

    @property
    def queue_wait_s(self) -> float:
        """Total queueing seconds on the prefill critical path."""
        gw = 0.0 if self.layer_gw_wait_s is None \
            else float(self.layer_gw_wait_s.sum())
        ex = 0.0 if self.layer_ex_wait_s is None \
            else float(self.layer_ex_wait_s.sum())
        return gw + ex


@dataclasses.dataclass
class ControlEvent:
    """One control-plane instant (AIMD step, replan decision, ...)."""

    t_s: float
    kind: str                  # "aimd" | "replan" | "joint"
    name: str                  # short display label
    plan: str                  # plan/schedule name the event belongs to
    args: dict                 # numeric/string payload for the exporter


@dataclasses.dataclass
class FlightLog:
    """One run's full observability record, ready to export."""

    plan_names: list[str]
    plan: int                  # the plan row the request records follow
    dt_s: float
    n_bins: int
    requests: list[RequestRecord]
    events: list[ControlEvent]
    probes: ProbeRecord | None
    scenario: str = ""
    summary: dict | None = None     # the plan row's metrics.row() dict

    @property
    def horizon_s(self) -> float:
        """Simulated wall-clock span, seconds."""
        return self.n_bins * self.dt_s

    def served(self) -> list[RequestRecord]:
        """The served subset of the request records."""
        return [r for r in self.requests if r.served]


def aimd_events(probes: ProbeRecord, plan_names: list[str],
                sweep: int = 0) -> list[ControlEvent]:
    """AIMD admit-state changes between consecutive recorded bins.

    One event per (recorded bin, plan) with any per-gateway admit
    motion; the args carry the mean admit before/after, the tightest
    gateway after the step and the window-max qhat that drove it.
    """
    if probes is None or not probes.admission_on or probes.n_recorded < 2:
        return []
    admit = probes.admit[:, sweep]                    # (B, P, G)
    qhat = probes.qhat_s[:, sweep]                    # (B, P)
    t = probes.t_s
    events: list[ControlEvent] = []
    for b in range(1, admit.shape[0]):
        delta = admit[b] - admit[b - 1]               # (P, G)
        for p in np.nonzero(np.abs(delta).max(axis=1) > 0)[0]:
            mean_before = float(admit[b - 1, p].mean())
            mean_after = float(admit[b, p].mean())
            direction = "down" if mean_after < mean_before else "up"
            events.append(ControlEvent(
                t_s=float(t[b]), kind="aimd",
                name=f"aimd {direction}",
                plan=plan_names[int(p)],
                args={
                    "admit_mean_before": round(mean_before, 4),
                    "admit_mean_after": round(mean_after, 4),
                    "admit_min_after": round(float(admit[b, p].min()), 4),
                    "n_gateways_changed":
                        int((np.abs(delta[p]) > 0).sum()),
                    "qhat_s": round(float(qhat[b, p]), 4),
                }))
    return events


def replan_events(report: "ReplanReport",
                  slot_period_s: float) -> list[ControlEvent]:
    """The re-placement controller's decision trajectory as instants
    (every decision; switches carry their migration byte flow)."""
    if report is None:
        return []
    names = [getattr(c, "name", f"cand{i}")
             for i, c in enumerate(report.candidates)]
    events: list[ControlEvent] = []
    for d in report.decisions:
        label = "replan switch" if d.switched else "replan hold"
        events.append(ControlEvent(
            t_s=d.t_s(slot_period_s), kind="replan",
            name=label, plan=report.schedule.name,
            args={
                "boundary": int(d.boundary),
                "slot": int(d.slot),
                "chosen": names[int(d.chosen)],
                "switched": bool(d.switched),
                "migration_bytes": float(d.migration_bytes),
                "best_score_s": round(float(np.min(d.scores)), 6),
            }))
    return events


def joint_decision_events(report: "ReplanReport") -> list[ControlEvent]:
    """The joint control plane's decision-event channel as instants.

    Emitted only for reports carrying a
    :class:`~repro_torch.obs.probes.DecisionTrace` (the fused grid path):
    one ``joint`` instant per decide boundary, with the full
    per-candidate score vector the on-device decide loop compared —
    the host controller's ``replan`` instants only carry the winner.
    """
    trace = getattr(report, "trace", None)
    if trace is None:
        return []
    names = [getattr(c, "name", f"cand{i}")
             for i, c in enumerate(report.candidates)]
    events: list[ControlEvent] = []
    t = trace.t_s
    for d in range(trace.n_decisions):
        switched = bool(trace.switched[d])
        events.append(ControlEvent(
            t_s=float(t[d]),
            kind="joint",
            name="joint switch" if switched else "joint decide",
            plan=report.schedule.name,
            args={
                "boundary": int(trace.boundaries[d]),
                "slot": int(trace.slots[d]),
                "chosen": names[int(trace.chosen[d])],
                "switched": switched,
                "migration_bytes": float(trace.migration_bytes[d]),
                "scores_s": [round(float(s), 6)
                             for s in trace.scores[d]],
            }))
    return events


def build_flight_log(
    sim: "FleetSim",
    result: "TrafficResult",
    plan: int | None = None,
    replan=None,
    scenario: str = "",
    sweep: int = 0,
) -> FlightLog:
    """Assemble the flight log of one finished run.

    Args:
        sim: The simulator the run executed on (its construction tables
            and — when built with ``probes=`` — its ``last_probes``).
        result: The run's :class:`~repro_torch.traffic.metrics.TrafficResult`.
        plan: Plan row the request records follow; ``None`` picks the
            last row (the replan schedule when one rode the sweep).
        replan: Optional controller report for the decision instants.
        scenario: Scenario name stamped into the log.
        sweep: Probe sweep entry to read (F axis; ``run`` has F = 1).

    Returns:
        The :class:`FlightLog` (requests, control events, probe ring).
    """
    p = (len(result.plans) - 1) if plan is None else int(plan)
    pt = result.plans[p]
    req = sim.requests
    probes = getattr(sim, "last_probes", None)
    # Per-request row into the simulator's per-plan tables.  A joint
    # control plane outcome stitches the decided schedule's row onto the
    # probe simulator's result, so that row has no row of its own there:
    # its per-request values are the decided candidate's.
    n_sim_rows = np.asarray(sim.ingress_extra).shape[0]
    row_of_req = np.full(req.n_requests, p, dtype=np.int64)
    if p >= n_sim_rows:
        if replan is None:
            raise ValueError(
                f"plan row {p} not in the simulator ({n_sim_rows} rows) "
                "and no replan report to resolve it from")
        row_of_req = np.asarray(replan.schedule.slot_plan)[
            np.asarray(sim.slots)[:req.n_requests]]
    retries = pt.retries if pt.retries is not None \
        else np.zeros(req.n_requests, dtype=np.int64)
    shed = pt.shed if pt.shed is not None \
        else np.zeros(req.n_requests, dtype=bool)

    records: list[RequestRecord] = []
    batching_on = probes is not None and probes.batch_b is not None
    probe_t = probes.t_s if probes is not None else None
    for r in range(req.n_requests):
        pr = int(row_of_req[r])
        gw_wait = ex_wait = None
        if probes is not None and probes.gw_wait_s is not None:
            gw_wait = probes.gw_wait_s[sweep, pr, r]
            ex_wait = probes.ex_wait_s[sweep, pr, r]
        batch_b = float("nan")
        if batching_on and pt.served[r] and np.isfinite(pt.e2e_s[r]):
            # Per-request batch span: mean B_eff over the recorded bins
            # of the decode span, at the plan's gateway satellites for
            # the request's topology slot.
            lo = req.arrival_s[r] + pt.ttft_s[r]
            hi = req.arrival_s[r] + pt.e2e_s[r]
            m = (probe_t >= lo) & (probe_t <= hi)
            if m.any():
                sats = sim.gateways_slot[pr, sim.slots[r]]     # (L,)
                batch_b = float(
                    probes.batch_b[m][:, sweep, pr][:, sats].mean())
        records.append(RequestRecord(
            rid=r,
            station=int(req.station[r]),
            arrival_s=float(req.arrival_s[r]),
            prompt_len=int(req.prompt_len[r]),
            decode_len=int(req.decode_len[r]),
            active=bool(pt.active[r]),
            served=bool(pt.served[r]),
            shed=bool(shed[r]),
            retries=int(retries[r]),
            ingress_s=float(sim.ingress_extra[pr, r]),
            ttft_s=float(pt.ttft_s[r]),
            tpot_s=float(pt.tpot_s[r]),
            e2e_s=float(pt.e2e_s[r]),
            layer_zero_s=np.asarray(sim.eff_layer[pr, r]),
            layer_gw_wait_s=gw_wait,
            layer_ex_wait_s=ex_wait,
            batch_b=batch_b,
        ))

    names = [q.plan_name for q in result.plans]
    events = aimd_events(probes, names, sweep=sweep)
    if replan is not None:
        events += replan_events(replan, sim.qcfg.slot_period_s)
        events += joint_decision_events(replan)
    events.sort(key=lambda e: e.t_s)
    return FlightLog(plan_names=names, plan=p, dt_s=result.dt_s,
                     n_bins=result.n_bins, requests=records,
                     events=events, probes=probes, scenario=scenario,
                     summary=pt.row())


def eq43_breakdown(sim: "FleetSim", plan: int,
                   tokens: np.ndarray | None = None) -> dict:
    """Zero-load Eq. 43 term decomposition for a plan row's tokens.

    Re-reads the engine's own tables (:func:`repro_torch.core.engine
    .eq43_layer_terms` — the engine's indexing) for
    ``d_out``/``t_exp``/``d_in``/``q`` per (token, layer, branch); the
    default token set is the R prefill macro-tokens.
    """
    from ..core.engine import eq43_layer_terms
    svc = sim.service_model
    tokens = np.arange(sim.n_requests) if tokens is None \
        else np.asarray(tokens)
    kwargs = {}
    if svc.per_satellite:
        kwargs = dict(expert_sec=np.asarray(svc.expert_s()),
                      inv_speed=np.asarray(svc.inv_speed(sim.n_stations)))
    return eq43_layer_terms(
        sim.batch, plan, sim.slots[tokens],
        np.asarray(sim.draws)[:, tokens], t_gateway=sim.t_gateway,
        t_expert=sim.t_expert, **kwargs)


def summarize_timeseries(probes: ProbeRecord, n_windows: int = 12,
                         plan: int = 0, sweep: int = 0) -> list[dict]:
    """Windowed fleet-state aggregates from the probe ring — flat rows
    shaped for :func:`repro_torch.traffic.metrics.format_table`.

    Args:
        probes: A probed run's :class:`~repro_torch.obs.probes.ProbeRecord`.
        n_windows: Number of equal recorded-bin windows to aggregate.
        plan: Plan row to aggregate.
        sweep: Probe sweep entry (F axis).

    Returns:
        One dict per window: window start time, fleet-max/mean backlog,
        peak per-satellite utilization, dropped seconds and — under
        admission — min admit and max qhat.
    """
    if probes is None or probes.n_recorded == 0:
        return []
    b = probes.n_recorded
    n_windows = max(1, min(int(n_windows), b))
    edges = np.linspace(0, b, n_windows + 1).astype(int)
    rows: list[dict] = []
    for w in range(n_windows):
        lo, hi = edges[w], max(edges[w] + 1, edges[w + 1])
        backlog = probes.backlog_s[lo:hi, sweep, plan]       # (w, S)
        util = probes.util_s[lo:hi, sweep, plan] / probes.dt_s
        drops = probes.drops_s[lo:hi, sweep, plan]
        row = {
            "t_s": round(float(probes.t_s[lo]), 2),
            "backlog_max_s": round(float(backlog.max()), 4),
            "backlog_mean_s": round(float(backlog.mean()), 4),
            "util_max": round(float(util.max()), 4),
            "dropped_s": round(float(drops.sum()), 4),
        }
        if probes.admission_on:
            row["admit_min"] = round(
                float(probes.admit[lo:hi, sweep, plan].min()), 4)
            row["qhat_max_s"] = round(
                float(probes.qhat_s[lo:hi, sweep, plan].max()), 4)
        rows.append(row)
    return rows
